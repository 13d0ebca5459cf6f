// The static-slicing exact datapath over 512-row crossbar segments
// (paper §4.1.4, §5.1; the datapath Algorithm 1 measures, §4.2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_crossbar.py
// (fused_crossbar / _kernel). Plain version:
// repro_torch/kernels/ref.py::fused_crossbar.
//
// What it computes, per output (b, c):
//   psum = sum_s xsum(b, s) * centers(s, c)                   (center term)
//        + sum_{s, i, j} clip(((x >> li) & mask_i) . w_j, lo, hi) * mults(i, j)
// over every segment s, input slice i and weight plane j; a clamp that sits
// on either ADC bound is a saturation, counted over the true (B, C) extent.
//
// Design (K2's, csrc/fused_spec_crossbar.cu, without the recovery). The
// grid runs one block per (32-column tile, batch-row tile, segment s,
// plane j) and each block adds its (b, c) contribution into the zeroed
// psum with an integer atomicAdd (exact and order-free). Inside a block, 4
// warps split the segment's 512 rows and meet in shared memory before the
// ADC clamp, which needs the whole column sum. Every input slice's column
// sum is linear in the input bits, so a block computes only the 8 bit-plane
// dots bd[p] = bit_p(x) . w_j per (b, c) and derives each slice's sum as
// sum_q bd[li + q] << q: 8 dots for any input slicing, (1,)*8 (Algorithm
// 1's search) and (8,) included. The x tile is staged in shared memory as
// packed bit planes (4 rows per 32-bit word, one byte per row), so a dot is
// a chain of __dp4a over 4 rows at a time; each thread streams its own
// column of the plane from device memory. Batch tiles of up to 8 rows (the
// search runs B = 16) reuse each loaded weight word for 8 x 8 dots; the
// staged bits and the warps' partial dots share one shared-memory buffer.
//
// What bounds it on an H100: at decode (B <= 64) the planes are read once
// per batch-row tile and nothing else is large, so the floor is the plane
// bytes over HBM bandwidth (3 int8 planes per weight at (4,2,2), ~1.41 GB
// per signed pass for qwen1.5-0.5b). At the decode shapes one call moves a
// few MB, so launch latency and the blocks in flight decide its time.
// Byte-wide weight loads and the dp4a rate keep it above the floor;
// tensor-core (mma.sync s8) bit-plane GEMMs are the later step.
//
// Integer arithmetic wraps modulo 2^32 like the reference's int32; the
// saturation count is 64-bit, reduced per block and added with one
// atomicAdd per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 512;         // rows per crossbar segment (ADC span)
constexpr int WORDS = ROWS / 4;   // packed 4-row words per segment
constexpr int BITS = 8;           // input code bits
constexpr int MAX_I = 8;          // input slices
constexpr int MAX_J = 8;          // weight planes
constexpr int BN = 32;            // columns per block, one per lane
constexpr int WARPS = 4;          // warps per block, splitting the rows
constexpr int WARP_WORDS = WORDS / WARPS;

struct Tables {
  int n_i;
  int li[MAX_I];
  int mask[MAX_I];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// grid (C/32, B/BM, n_seg * n_j), block 128 threads
template <int BM>
__global__ void __launch_bounds__(BN * WARPS) crossbar_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, const int32_t* __restrict__ centers,
    int32_t* __restrict__ out, unsigned long long* __restrict__ sats,
    int B, int R, int C, int n_seg, int n_j, int lo, int hi, Tables tab) {
  // First the bit planes of the staged x tile, xbits[b][k][p] = bit p of
  // rows 4k..4k+3 of batch row b, one byte per row; then the per-warp
  // partial dots part[warp][b][p][lane]. Both hold BM * 1024 words.
  __shared__ __align__(16) uint32_t buf[BM * WORDS * BITS];
  __shared__ uint32_t xsum[BM];
  __shared__ unsigned long long red;
  auto xbits = reinterpret_cast<uint32_t (*)[WORDS][BITS]>(buf);
  auto part = reinterpret_cast<int (*)[BM][BITS][BN]>(buf);

  const int tid = threadIdx.x;
  const int lane = tid % BN, warp = tid / BN;
  const int c = blockIdx.x * BN + lane;
  const int b0 = blockIdx.y * BM;
  const int s = blockIdx.z / n_j, j = blockIdx.z % n_j;
  const bool col_ok = c < C;

  if (tid == 0) red = 0ull;
  if (tid < BM) xsum[tid] = 0u;
  __syncthreads();
  for (int e = tid; e < BM * WORDS; e += BN * WARPS) {
    const int b = e / WORDS, k = e % WORDS;
    const int bb = b0 + b;
    const int r0 = s * ROWS + 4 * k;
    int v[4];
    uint32_t sum = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = (bb < B && r0 + q < R) ? x[(size_t)bb * R + r0 + q] : 0;
      sum += (uint32_t)v[q];
    }
#pragma unroll
    for (int p = 0; p < BITS; ++p) {
      uint32_t word = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) word |= (uint32_t)((v[q] >> p) & 1) << (8 * q);
      xbits[b][k][p] = word;
    }
    atomicAdd(&xsum[b], sum);
  }
  __syncthreads();

  // this warp's quarter of the segment's rows
  int bd[BM][BITS];
#pragma unroll
  for (int b = 0; b < BM; ++b)
#pragma unroll
    for (int p = 0; p < BITS; ++p) bd[b][p] = 0;
  if (col_ok) {
    const size_t Rp = (size_t)n_seg * ROWS;
    const int8_t* wp = w + ((size_t)j * Rp + (size_t)s * ROWS) * C + c;
    for (int k = warp * WARP_WORDS; k < (warp + 1) * WARP_WORDS; ++k) {
      const int8_t* wr = wp + (size_t)(4 * k) * C;
      const uint32_t w4 = (uint32_t)(uint8_t)__ldg(wr) |
                          ((uint32_t)(uint8_t)__ldg(wr + C) << 8) |
                          ((uint32_t)(uint8_t)__ldg(wr + 2 * (size_t)C) << 16) |
                          ((uint32_t)(uint8_t)__ldg(wr + 3 * (size_t)C) << 24);
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        const uint4 lo4 = *reinterpret_cast<const uint4*>(&xbits[b][k][0]);
        const uint4 hi4 = *reinterpret_cast<const uint4*>(&xbits[b][k][4]);
        bd[b][0] = __dp4a((int)lo4.x, (int)w4, bd[b][0]);
        bd[b][1] = __dp4a((int)lo4.y, (int)w4, bd[b][1]);
        bd[b][2] = __dp4a((int)lo4.z, (int)w4, bd[b][2]);
        bd[b][3] = __dp4a((int)lo4.w, (int)w4, bd[b][3]);
        bd[b][4] = __dp4a((int)hi4.x, (int)w4, bd[b][4]);
        bd[b][5] = __dp4a((int)hi4.y, (int)w4, bd[b][5]);
        bd[b][6] = __dp4a((int)hi4.z, (int)w4, bd[b][6]);
        bd[b][7] = __dp4a((int)hi4.w, (int)w4, bd[b][7]);
      }
    }
  }
  __syncthreads();  // every warp is done with xbits: reuse it for part
#pragma unroll
  for (int b = 0; b < BM; ++b)
#pragma unroll
    for (int p = 0; p < BITS; ++p) part[warp][b][p][lane] = bd[b][p];
  __syncthreads();

  // warp w finishes batch rows w, w + 4, ...: input slices, ADC,
  // saturation count, shift+add, and (plane 0 only) the center term
  unsigned int sat_cnt = 0u;
  for (int b = warp; b < BM; b += WARPS) {
    if (b0 + b >= B || !col_ok) continue;
    int d[BITS];
#pragma unroll
    for (int p = 0; p < BITS; ++p) {
      int acc = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) acc += part[q][b][p][lane];
      d[p] = acc;
    }
    uint32_t contrib = 0u;
    if (j == 0) contrib = xsum[b] * (uint32_t)centers[(size_t)s * C + c];
    for (int i = 0; i < tab.n_i; ++i) {
      const int li = tab.li[i], mask = tab.mask[i];
      int v = 0;
#pragma unroll
      for (int p = 0; p < BITS; ++p) {
        const int q = p - li;
        if (q >= 0 && ((mask >> q) & 1)) v += d[p] * (1 << q);
      }
      const int cs = clampi(v, lo, hi);
      sat_cnt += (cs == lo || cs == hi) ? 1u : 0u;
      contrib += (uint32_t)cs * (uint32_t)mults[i * n_j + j];
    }
    atomicAdd(reinterpret_cast<unsigned int*>(out) + (size_t)(b0 + b) * C + c,
              contrib);
  }
  if (sat_cnt) atomicAdd(&red, (unsigned long long)sat_cnt);
  __syncthreads();
  if (tid == 0 && red) atomicAdd(sats, red);
}

template <int BM>
cudaError_t launch(const int32_t* x, const int8_t* w, const int32_t* mults,
                   const int32_t* centers, int32_t* out,
                   unsigned long long* sats, int B, int R, int C, int n_seg,
                   int n_j, int lo, int hi, const Tables& tab,
                   cudaStream_t stream) {
  const dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, n_seg * n_j);
  crossbar_kernel<BM><<<grid, BN * WARPS, 0, stream>>>(
      x, w, mults, centers, out, sats, B, R, C, n_seg, n_j, lo, hi, tab);
  return cudaGetLastError();
}

}  // namespace

// x (B, R) int32 codes 0..255; w (n_j, n_seg*512, C) int8; mults (n_i, n_j)
// int32; centers (n_seg, C) int32; out (B, C) int32 and sats () int64, both
// zeroed by the caller: blocks add into them. li / mask (n_i,) are host
// tables; the caller guarantees li + (bits of mask) <= 8 (the 8 bit planes
// are all the kernel computes). bm (1, 2, 4 or 8) is the batch-row tile.
// Returns the launch's cudaError_t.
extern "C" int fused_crossbar_launch(
    const void* x, const void* w, const void* mults, const void* centers,
    void* out, void* sats, int B, int R, int C, int n_seg, int n_j, int n_i,
    const int* li, const int* mask, int adc_lo, int adc_hi, int bm,
    void* stream) {
  if (n_i < 1 || n_i > MAX_I || n_j < 1 || n_j > MAX_J || B < 1 || C < 1 ||
      n_seg < 1 || R > n_seg * ROWS || n_seg * n_j > 65535)
    return (int)cudaErrorInvalidValue;
  Tables tab{};
  tab.n_i = n_i;
  for (int i = 0; i < n_i; ++i) {
    tab.li[i] = li[i];
    tab.mask[i] = mask[i];
  }
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* mp = static_cast<const int32_t*>(mults);
  const auto* cp = static_cast<const int32_t*>(centers);
  auto* op = static_cast<int32_t*>(out);
  auto* sp = static_cast<unsigned long long*>(sats);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return (int)launch<1>(xp, wp, mp, cp, op, sp, B, R, C, n_seg, n_j, adc_lo, adc_hi, tab, st);
    case 2: return (int)launch<2>(xp, wp, mp, cp, op, sp, B, R, C, n_seg, n_j, adc_lo, adc_hi, tab, st);
    case 4: return (int)launch<4>(xp, wp, mp, cp, op, sp, B, R, C, n_seg, n_j, adc_lo, adc_hi, tab, st);
    case 8: return (int)launch<8>(xp, wp, mp, cp, op, sp, B, R, C, n_seg, n_j, adc_lo, adc_hi, tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
