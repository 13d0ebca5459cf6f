// Crossbar contraction of pre-sliced inputs with a per-segment ADC
// (paper §4.1.4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_crossbar.py
// (sliced_crossbar_matmul / _kernel). Plain version:
// repro_torch/kernels/ref.py::sliced_crossbar_matmul.
//
// What it computes, per output (b, c):
//   out = sum_{s, i, j} clip(x_i[b, seg s] . w_j[seg s, c], lo, hi) * mults(i, j)
// over 512-row segments s, input slices i and weight planes j. There is no
// center term and no counter: it is K1's function (csrc/fused_crossbar.cu)
// on inputs that arrive already sliced, as any int8 values.
//
// Design (K1's first, dp4a skeleton; K1 now runs the bit-plane GEMM of
// bitplane_gemm.cuh, which takes codes, not pre-sliced values). One block per (32-column tile, batch-row tile,
// segment s, plane j) adds into the zeroed output with an integer
// atomicAdd; 4 warps split the segment's 512 rows and meet in shared memory
// before the clamp. The block stages every input slice's rows of the
// segment in shared memory as packed int8 words (4 rows per word), so each
// weight word a thread loads from device memory feeds one signed __dp4a per
// (batch row, input slice). Rows at or past R read as zero on both sides.
// The staged slices and the warps' partial dots share one buffer.
//
// What bounds it on an H100: the planes' bytes, read once per batch-row
// tile, over HBM bandwidth at the shapes it runs (B = 4); launch latency at
// a few MB per call. Integer arithmetic wraps modulo 2^32 like the
// reference's int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 512;         // rows per crossbar segment (ADC span)
constexpr int WORDS = ROWS / 4;   // packed 4-row words per segment
constexpr int MAX_I = 8;          // input slices
constexpr int MAX_J = 8;          // weight planes
constexpr int BN = 32;            // columns per block, one per lane
constexpr int WARPS = 4;          // warps per block, splitting the rows
constexpr int WARP_WORDS = WORDS / WARPS;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// grid (C/32, B/BM, n_seg * n_j), block 128 threads
template <int BM>
__global__ void __launch_bounds__(BN * WARPS) sliced_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, int32_t* __restrict__ out, int n_i,
    int B, int R, int C, int n_j, int lo, int hi) {
  // First the staged slices, xw[b][k][i] = rows 4k..4k+3 of slice i of
  // batch row b, one byte per row; then the per-warp partial dots
  // part[warp][b][i][lane]. Both hold BM * 1024 words.
  __shared__ __align__(16) uint32_t buf[BM * WORDS * MAX_I];
  auto xw = reinterpret_cast<uint32_t (*)[WORDS][MAX_I]>(buf);
  auto part = reinterpret_cast<int (*)[BM][MAX_I][BN]>(buf);

  const int tid = threadIdx.x;
  const int lane = tid % BN, warp = tid / BN;
  const int c = blockIdx.x * BN + lane;
  const int b0 = blockIdx.y * BM;
  const int s = blockIdx.z / n_j, j = blockIdx.z % n_j;
  const bool col_ok = c < C;

  for (int e = tid; e < BM * WORDS * MAX_I; e += BN * WARPS) {
    const int b = e / (WORDS * MAX_I), k = (e / MAX_I) % WORDS, i = e % MAX_I;
    const int bb = b0 + b;
    const int r0 = s * ROWS + 4 * k;
    uint32_t word = 0u;
    if (i < n_i && bb < B) {
      const int8_t* xr = x + ((size_t)i * B + bb) * R;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + q < R) word |= (uint32_t)(uint8_t)xr[r0 + q] << (8 * q);
    }
    xw[b][k][i] = word;
  }
  __syncthreads();

  // this warp's quarter of the segment's rows
  int acc[BM][MAX_I];
#pragma unroll
  for (int b = 0; b < BM; ++b)
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) acc[b][i] = 0;
  if (col_ok) {
    const int8_t* wp = w + (size_t)j * R * C + c;
    for (int k = warp * WARP_WORDS; k < (warp + 1) * WARP_WORDS; ++k) {
      const int r0 = s * ROWS + 4 * k;
      if (r0 >= R) break;
      uint32_t w4 = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + q < R)
          w4 |= (uint32_t)(uint8_t)__ldg(wp + (size_t)(r0 + q) * C) << (8 * q);
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        const uint4 lo4 = *reinterpret_cast<const uint4*>(&xw[b][k][0]);
        const uint4 hi4 = *reinterpret_cast<const uint4*>(&xw[b][k][4]);
        acc[b][0] = __dp4a((int)lo4.x, (int)w4, acc[b][0]);
        acc[b][1] = __dp4a((int)lo4.y, (int)w4, acc[b][1]);
        acc[b][2] = __dp4a((int)lo4.z, (int)w4, acc[b][2]);
        acc[b][3] = __dp4a((int)lo4.w, (int)w4, acc[b][3]);
        acc[b][4] = __dp4a((int)hi4.x, (int)w4, acc[b][4]);
        acc[b][5] = __dp4a((int)hi4.y, (int)w4, acc[b][5]);
        acc[b][6] = __dp4a((int)hi4.z, (int)w4, acc[b][6]);
        acc[b][7] = __dp4a((int)hi4.w, (int)w4, acc[b][7]);
      }
    }
  }
  __syncthreads();  // every warp is done with xw: reuse it for part
#pragma unroll
  for (int b = 0; b < BM; ++b)
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) part[warp][b][i][lane] = acc[b][i];
  __syncthreads();

  // warp w finishes batch rows w, w + 4, ...: ADC clamp and shift+add
  for (int b = warp; b < BM; b += WARPS) {
    if (b0 + b >= B || !col_ok) continue;
    uint32_t contrib = 0u;
    for (int i = 0; i < n_i; ++i) {
      int v = 0;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) v += part[q][b][i][lane];
      contrib += (uint32_t)clampi(v, lo, hi) * (uint32_t)mults[i * n_j + j];
    }
    atomicAdd(reinterpret_cast<unsigned int*>(out) + (size_t)(b0 + b) * C + c,
              contrib);
  }
}

template <int BM>
cudaError_t launch(const int8_t* x, const int8_t* w, const int32_t* mults,
                   int32_t* out, int n_i, int B, int R, int C, int n_seg,
                   int n_j, int lo, int hi, cudaStream_t stream) {
  const dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, n_seg * n_j);
  sliced_kernel<BM><<<grid, BN * WARPS, 0, stream>>>(
      x, w, mults, out, n_i, B, R, C, n_j, lo, hi);
  return cudaGetLastError();
}

}  // namespace

// x (n_i, B, R) int8; w (n_j, R, C) int8; mults (n_i, n_j) int32; out
// (B, C) int32, zeroed by the caller: blocks add into it. bm (1, 2, 4 or 8)
// is the batch-row tile. Returns the launch's cudaError_t.
extern "C" int sliced_crossbar_launch(
    const void* x, const void* w, const void* mults, void* out, int n_i,
    int B, int R, int C, int n_j, int adc_lo, int adc_hi, int bm,
    void* stream) {
  const int n_seg = (R + ROWS - 1) / ROWS;
  if (n_i < 1 || n_i > MAX_I || n_j < 1 || n_j > MAX_J || B < 1 || C < 1 ||
      R < 1 || n_seg * n_j > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* mp = static_cast<const int32_t*>(mults);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return (int)launch<1>(xp, wp, mp, op, n_i, B, R, C, n_seg, n_j, adc_lo, adc_hi, st);
    case 2: return (int)launch<2>(xp, wp, mp, op, n_i, B, R, C, n_seg, n_j, adc_lo, adc_hi, st);
    case 4: return (int)launch<4>(xp, wp, mp, op, n_i, B, R, C, n_seg, n_j, adc_lo, adc_hi, st);
    case 8: return (int)launch<8>(xp, wp, mp, op, n_i, B, R, C, n_seg, n_j, adc_lo, adc_hi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sliced_crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
