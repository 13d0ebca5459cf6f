// Centered int8 matmul: y = x_q @ w_off + rowsum(x_q) * centers (paper Eq. 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py
// (centered_int8_matmul / _kernel). Plain version:
// repro_torch/kernels/ref.py::centered_int8_matmul.
//
// x (B, K) int8, w_off (K, N) int8 row-major, centers (N,) int32 ->
// y (B, N) int32, wrapping modulo 2^32 like the reference's int32.
//
// Design. The grid runs one block per (128-column tile, batch-row tile,
// K range): a decode shape has too few column tiles to fill 132 SMs, so K
// is split across blocks, and each block adds its partial product into the
// zeroed output with an integer atomicAdd (exact and order-free). A block
// stages its x rows in shared memory, packed as the natural 4-byte words of
// an int8 row, and accumulates their row sum alongside; each thread
// streams its own column of w_off from device memory, packs 4 consecutive
// K rows into one word and runs __dp4a against every staged batch row. The
// rank-1 center term rides with the partial product: sum over the K ranges
// of (partial dot + partial row sum * center) is the whole of Eq. 1.
//
// What bounds it on an H100: at decode (B <= 64) the product reads every
// w_off byte once per batch-row tile and does 2*B ops per byte, far below
// the int8 tensor-core ridge, so the floor is the w_off bytes over HBM
// bandwidth (~0.46 GB per decode step for qwen1.5-0.5b). At the decode
// shapes one call moves one to a few MB, so launch latency and blocks in
// flight decide its time, which the K split addresses; byte-wide loads
// keep it above the floor, and wider loads and mma.sync s8 tiles are the
// later step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;    // columns per block, one per thread
constexpr int KC = 1024;   // K rows staged per chunk

// grid (N/128, B/BM, ksplit); block z covers K rows [z*kr, (z+1)*kr)
template <int BM>
__global__ void __launch_bounds__(BN) int8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ centers, int32_t* __restrict__ out,
    int B, int K, int N, int kr) {
  __shared__ uint32_t xs[BM][KC / 4];
  __shared__ int32_t xsum[BM];

  const int tid = threadIdx.x;
  const int c = blockIdx.x * BN + tid;
  const int b0 = blockIdx.y * BM;
  const int k_lo = blockIdx.z * kr;
  const int k_hi = min(K, k_lo + kr);
  const bool col_ok = c < N;

  if (tid < BM) xsum[tid] = 0;
  int acc[BM];
#pragma unroll
  for (int b = 0; b < BM; ++b) acc[b] = 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
    const int words = (min(KC, k_hi - k0) + 3) / 4;
    __syncthreads();  // previous chunk's readers are done (and xsum is set)
    for (int e = tid; e < BM * words; e += BN) {
      const int b = e / words, kk = e % words;
      const int bb = b0 + b;
      uint32_t word = 0u;
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + 4 * kk + q;
        const int v = (bb < B && k < k_hi) ? (int)x[(size_t)bb * K + k] : 0;
        word |= (uint32_t)(uint8_t)v << (8 * q);
        sum += v;
      }
      xs[b][kk] = word;
      atomicAdd(&xsum[b], sum);
    }
    __syncthreads();
    if (!col_ok) continue;
    const int8_t* wp = w + (size_t)k0 * N + c;
    for (int kk = 0; kk < words; ++kk) {
      uint32_t w4 = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * kk + q;
        if (k0 + k < k_hi) w4 |= (uint32_t)(uint8_t)__ldg(wp + (size_t)k * N) << (8 * q);
      }
#pragma unroll
      for (int b = 0; b < BM; ++b) acc[b] = __dp4a((int)xs[b][kk], (int)w4, acc[b]);
    }
  }
  __syncthreads();
  if (!col_ok) return;
  const uint32_t cen = (uint32_t)centers[c];
#pragma unroll
  for (int b = 0; b < BM; ++b)
    if (b0 + b < B)
      atomicAdd(reinterpret_cast<unsigned int*>(out) + (size_t)(b0 + b) * N + c,
                (uint32_t)acc[b] + (uint32_t)xsum[b] * cen);
}

template <int BM>
cudaError_t launch(const int8_t* x, const int8_t* w, const int32_t* centers,
                   int32_t* out, int B, int K, int N, int ksplit,
                   cudaStream_t stream) {
  const int kr = ((K + ksplit - 1) / ksplit + 3) / 4 * 4;  // rows per block
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM, (K + kr - 1) / kr);
  int8_kernel<BM><<<grid, BN, 0, stream>>>(x, w, centers, out, B, K, N, kr);
  return cudaGetLastError();
}

}  // namespace

// x (B, K) int8; w (K, N) int8; centers (N,) int32; out (B, N) int32,
// zeroed by the caller (blocks add into it); ksplit K ranges per column.
// Returns the launch's cudaError_t.
extern "C" int centered_int8_matmul_launch(const void* x, const void* w,
                                           const void* centers, void* out,
                                           int B, int K, int N, int bm,
                                           int ksplit, void* stream) {
  if (B < 1 || K < 1 || N < 1 || ksplit < 1 || ksplit > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* cp = static_cast<const int32_t*>(centers);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 1: return (int)launch<1>(xp, wp, cp, op, B, K, N, ksplit, st);
    case 2: return (int)launch<2>(xp, wp, cp, op, B, K, N, ksplit, st);
    case 4: return (int)launch<4>(xp, wp, cp, op, B, K, N, ksplit, st);
    case 8: return (int)launch<8>(xp, wp, cp, op, B, K, N, ksplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* centered_int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
