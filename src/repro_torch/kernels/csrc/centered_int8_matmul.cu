// Centered int8 matmul: y = x_q @ w_off + rowsum(x_q) * centers (paper Eq. 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (centered_int8_matmul / _kernel). Plain version:
// repro_torch/kernels/ref.py::centered_int8_matmul. Tile plan (tile sizes,
// cluster size, K range per block, shared memory): int8_matmul.py::tile_plan.
//
// x (B, K) int8, w_off (K, N) int8 row-major, centers (N,) int32 ->
// y (B, N) int32, wrapping modulo 2^32 like the reference's int32.
//
// What bounds it on an H100. At decode (B <= 64) the product does 2*B
// operations per weight byte, far below the int8 tensor-core ridge
// (~590 ops per byte), so the floor is w_off's bytes over HBM bandwidth.
// A layer projection moves 1-3 MB: spread over 132 SMs that is 8-22 KB per
// SM, so one call is a launch plus about one HBM round trip, and the kernel
// has to put those bytes in flight at once rather than stream them.
//
// Design, one answer per cause:
// - 16-byte loads, enough in flight. Each block stages its (BK x BN) w_off
//   tiles and the matching x columns through a ring of STAGES shared-memory
//   stages with cp.async.cg (16 bytes a thread, zero-filled past the edges,
//   with an L2 128-byte prefetch hint: a block reads 64 bytes of each K row
//   and its neighbour the next 64); a stage is 8 KB of weights, so a block
//   keeps up to 24 KB in flight, and a decode-shape layer call has all of
//   its weights in flight at once (128-176 blocks of 8-22 KB).
//   Operands whose rows are not 16-byte aligned (N or K not a multiple of
//   16) take the same path with bounds-checked word loads (VEC = false).
// - int8 tensor cores at every B. mma.sync m16n8k32 s8.s8.s32 (no
//   .satfinite: the reference wraps) with output columns on the 16-wide
//   side and batch rows on the 8-wide side, so B <= 8 is one n8 tile and
//   B = 64 eight, and a block reads each weight byte once for all its batch
//   rows. A fragment needs 4 consecutive K values of one column while w_off
//   is row-major: each thread loads one 32-bit word (4 columns) from each
//   of 4 K rows and transposes the 4x4 bytes with __byte_perm, which yields
//   the same register of 4 m16 tiles at once; MMA row m of tile i is output
//   column 32*(m/8) + 4*(m%8) + i. The stage's 16-byte chunks are XOR-
//   swizzled by K row, which halves the bank conflicts of those loads.
// - No zeroed output, no global atomics. K is split across the blocks of a
//   thread-block cluster (1, 2, 4 or 8, portable); the 4 warps of a block
//   split each stage's 128 K rows. Warps reduce through shared memory,
//   blocks through distributed shared memory: each rank owns a slice of the
//   output tile, every rank pushes its partials for that slice into the
//   owner's inbox (remote stores, no round trips), and after one cluster
//   barrier the owner sums them and writes each y element once with its
//   center term. The barrier that makes the pushes safe (every block of
//   the cluster running) is split: arrived at the start, waited on after
//   the K loop.
// - Row sums in the epilogue's operands: each thread dp4a's its x fragment
//   words against 0x01010101, the 4 threads of a group and the warps and
//   ranks reduce them like the products; no shared-memory atomics.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;       // output columns per block: 4 m16 tiles a warp
constexpr int BK = 128;      // K rows per stage: 32 per warp
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int WARPS = 4;
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int THREADS = 32 * WARPS;
constexpr int XS = BK + 16;  // staged x row stride in bytes (spreads banks)
constexpr int W_STAGE = BK * BN;

__host__ __device__ constexpr int stage_bytes(int bt) {
  return W_STAGE + bt * XS;
}
// the ring, reused after the K loop for the warps' partial tiles; then,
// in a cluster of 2 or more, the inbox of the cluster reduction (an int32
// tile apart from the ring: a rank may push while its owner still loops;
// a lone block reduces in place); then MAX_CLUSTER x bt pushed row sums
// and the warps' row sums (WARPS x bt)
__host__ __device__ constexpr int region_bytes(int bt) {
  return STAGES * stage_bytes(bt) > WARPS * bt * BN * 4
             ? STAGES * stage_bytes(bt) : WARPS * bt * BN * 4;
}
__host__ __device__ constexpr int inbox_bytes(int bt, int cluster) {
  return cluster > 1 ? bt * BN * 4 : 0;
}
__host__ __device__ constexpr int smem_bytes(int bt, int cluster) {
  return region_bytes(bt) + inbox_bytes(bt, cluster) +
         (MAX_CLUSTER + WARPS) * bt * 4;
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

// byte offset of (K row r, 16-byte column chunk c) in a staged w_off tile
__device__ __forceinline__ int w_off_in_stage(int r, int c) {
  return r * BN + ((c ^ ((r >> 2) & 3)) << 4);
}

// Stage K rows [k0, k0 + BK) of w_off columns [col0, col0 + BN) and of x
// rows [b0, b0 + BT); rows at or past k_hi and columns or batch rows past
// the operands read as zero.
template <int BT, bool VEC>
__device__ __forceinline__ void load_stage(
    uint8_t* st, const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    int B, int K, int N, int b0, int col0, int k0, int k_hi) {
  uint8_t* xs = st + W_STAGE;
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < BK * (BN / 16); e += THREADS) {
      const int r = e >> 2, c = e & 3, k = k0 + r, col = col0 + 16 * c;
      const bool ok = k < k_hi && col < N;
      cp16(st + w_off_in_stage(r, c), ok ? w + (size_t)k * N + col : w,
           ok ? 16 : 0);
    }
    for (int e = threadIdx.x; e < BT * (BK / 16); e += THREADS) {
      const int b = e >> 3, c = e & 7, k = k0 + 16 * c, row = b0 + b;
      const bool ok = row < B && k < k_hi;  // k_hi is a multiple of 16
      cp16(xs + b * XS + 16 * c, ok ? x + (size_t)row * K + k : x,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * (BN / 4); e += THREADS) {
      const int r = e >> 4, wd = e & 15, k = k0 + r, col = col0 + 4 * wd;
      uint32_t v = 0u;
      if (k < k_hi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < N)
            v |= (uint32_t)(uint8_t)w[(size_t)k * N + col + q] << (8 * q);
      *reinterpret_cast<uint32_t*>(st + w_off_in_stage(r, wd >> 2) +
                                   4 * (wd & 3)) = v;
    }
    for (int e = threadIdx.x; e < BT * (BK / 4); e += THREADS) {
      const int b = e / (BK / 4), wd = e % (BK / 4), k = k0 + 4 * wd;
      const int row = b0 + b;
      uint32_t v = 0u;
      if (row < B)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < k_hi)
            v |= (uint32_t)(uint8_t)x[(size_t)row * K + k + q] << (8 * q);
      *reinterpret_cast<uint32_t*>(xs + b * XS + 4 * wd) = v;
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

// grid (column tiles * cluster, batch tiles), cluster (cluster, 1, 1):
// cluster rank r covers K rows [r*kpr, min(K, (r+1)*kpr)), empty past K.
template <int NT, bool VEC>
__global__ void __launch_bounds__(THREADS) int8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ centers, int32_t* __restrict__ out,
    int B, int K, int N, int kpr) {
  constexpr int BT = 8 * NT;
  constexpr int SB = stage_bytes(BT);
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int col0 = (blockIdx.x / cs) * BN;
  const int b0 = blockIdx.y * BT;
  const int k_lo = rank * kpr;
  const int k_hi = min(K, k_lo + kpr);
  const int nk = (k_hi - k_lo + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  cluster_arrive();  // waited on before the reduction's remote stores

  int acc[4][NT][4];
  int rs[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    rs[n] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BT, VEC>(smem + s * SB, x, w, B, K, N, b0, col0,
                          k_lo + s * BK, k_hi);
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_wait<STAGES - 2>();  // stage `it` has landed for this thread
    __syncthreads();        // ... for all threads; slot of it-1 is free
    const int nx = it + STAGES - 1;
    if (nx < nk)
      load_stage<BT, VEC>(smem + (nx % STAGES) * SB, x, w, B, K, N, b0, col0,
                          k_lo + nx * BK, k_hi);
    cp_commit();
    const uint8_t* ws = smem + (it % STAGES) * SB;
    const uint8_t* xs = ws + W_STAGE;
    // a[i][reg]: register reg of m16 tile i. reg = 2*kh + h holds K rows
    // 16*kh + 4t .. +3 of column 32h + 4g + i.
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
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint8_t* xr = xs + (8 * n + g) * XS + warp * 32 + 4 * t;
      const uint32_t bx0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t bx1 = *reinterpret_cast<const uint32_t*>(xr + 16);
      rs[n] = __dp4a((int)bx0, 0x01010101, rs[n]);
      rs[n] = __dp4a((int)bx1, 0x01010101, rs[n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[i][n], a[i], bx0, bx1);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the partial tiles

  int32_t* red = reinterpret_cast<int32_t*>(smem);  // [WARPS][BT][BN]
  int32_t* inbox = cs > 1 ? reinterpret_cast<int32_t*>(
                                smem + region_bytes(BT)) : red;
  int32_t* rs_in = reinterpret_cast<int32_t*>(
      smem + region_bytes(BT) + inbox_bytes(BT, cs));  // [MAX_CLUSTER][BT]
  int32_t* rs_w = rs_in + MAX_CLUSTER * BT;            // [WARPS][BT]
  int32_t* mine = red + warp * BT * BN;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int bb = 8 * n + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = 4 * g + i;
      mine[bb * BN + cc] = acc[i][n][0];
      mine[(bb + 1) * BN + cc] = acc[i][n][1];
      mine[bb * BN + cc + 32] = acc[i][n][2];
      mine[(bb + 1) * BN + cc + 32] = acc[i][n][3];
    }
    int v = rs[n];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) rs_w[warp * BT + 8 * n + g] = v;
  }
  __syncthreads();
  // Rank r owns tile elements [r*per, (r+1)*per). Every rank pushes the sum
  // of its warps' partials for those elements into slot `rank` of r's
  // inbox, and its row sums to every rank: stores into the other blocks'
  // shared memory, no round trips. The arrive at the kernel's start,
  // waited on here, says every block of the cluster is running.
  cluster_wait();
  const int per = BT * BN / cs;  // cs is a power of two <= 8
  for (int e = threadIdx.x; e < BT * BN; e += THREADS) {
    uint32_t s = 0u;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += (uint32_t)red[q * BT * BN + e];
    cluster.map_shared_rank(inbox, e / per)[rank * per + e % per] =
        (int32_t)s;
  }
  for (int b = threadIdx.x; b < BT; b += THREADS) {
    uint32_t s = 0u;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += (uint32_t)rs_w[q * BT + b];
    for (int r = 0; r < cs; ++r)
      cluster.map_shared_rank(rs_in, r)[rank * BT + b] = (int32_t)s;
  }
  cluster.sync();  // every push has landed; no block reads another after it
  for (int j = threadIdx.x; j < per; j += THREADS) {
    const int e = rank * per + j;
    const int b = e / BN, c = e % BN, row = b0 + b, col = col0 + c;
    if (row >= B || col >= N) continue;
    uint32_t s = 0u, xs = 0u;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cs) {
        s += (uint32_t)inbox[q * per + j];
        xs += (uint32_t)rs_in[q * BT + b];
      }
    out[(size_t)row * N + col] =
        (int32_t)(s + xs * (uint32_t)centers[col]);
  }
}

template <int NT, bool VEC>
cudaError_t launch(const int8_t* x, const int8_t* w, const int32_t* centers,
                   int32_t* out, int B, int K, int N, int cluster, int kpr,
                   cudaStream_t stream) {
  constexpr int BT = 8 * NT;
  auto kern = int8_kernel<NT, VEC>;
  static bool smem_set = false;  // one attribute call per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(BT, MAX_CLUSTER));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * cluster, (B + BT - 1) / BT, 1);
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
  return cudaLaunchKernelEx(&cfg, kern, x, w, centers, out, B, K, N, kpr);
}

template <bool VEC>
cudaError_t launch_bt(const int8_t* x, const int8_t* w, const int32_t* c,
                      int32_t* out, int B, int K, int N, int bt, int cluster,
                      int kpr, cudaStream_t st) {
  switch (bt) {
    case 8: return launch<1, VEC>(x, w, c, out, B, K, N, cluster, kpr, st);
    case 16: return launch<2, VEC>(x, w, c, out, B, K, N, cluster, kpr, st);
    case 32: return launch<4, VEC>(x, w, c, out, B, K, N, cluster, kpr, st);
    case 64: return launch<8, VEC>(x, w, c, out, B, K, N, cluster, kpr, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, K) int8; w (K, N) int8; centers (N,) int32; out (B, N) int32, every
// element written once. The tile plan (int8_matmul.py::tile_plan) is checked
// against this source's constants: bn, bk, stages and smem must equal them;
// bt is the batch tile (8, 16, 32 or 64), cluster the K split (1, 2, 4 or
// 8) and kpr the K rows per rank (a multiple of 32; the ranks cover K, and a
// rank past K adds zeros). Operands whose rows all start 16-byte aligned
// take the cp.async path, others the word-load path.
// Returns the launch's cudaError_t.
extern "C" int centered_int8_matmul_launch(
    const void* x, const void* w, const void* centers, void* out, int B,
    int K, int N, int bn, int bk, int stages, int bt, int cluster, int kpr,
    int smem, void* stream) {
  if (B < 1 || K < 1 || N < 1 || bn != BN || bk != BK || stages != STAGES ||
      (bt != 8 && bt != 16 && bt != 32 && bt != 64) ||
      smem != smem_bytes(bt, cluster) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      kpr < 32 || kpr % 32 != 0 || (long long)cluster * kpr < K ||
      (B + bt - 1) / bt > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* cp = static_cast<const int32_t*>(centers);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_bt<true>(xp, wp, cp, op, B, K, N, bt, cluster,
                                     kpr, st)
                   : launch_bt<false>(xp, wp, cp, op, B, K, N, bt, cluster,
                                      kpr, st));
}

extern "C" const char* centered_int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
