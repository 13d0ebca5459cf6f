// Crossbar contraction of pre-sliced inputs with a per-segment ADC
// (paper §4.1.4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_crossbar.py
// (sliced_crossbar_matmul / _kernel). Plain version:
// repro_torch/kernels/ref.py::sliced_crossbar_matmul. Tile plan (batch
// tile, cluster size, (segment, plane) pairs per rank, shared memory,
// grid): bitplane.py::tile_plan with the slice operand, through
// sliced_crossbar.py::tile_plan.
//
// What it computes, per output (b, c):
//   out = sum_{s, i, j} clip(x_i[b, seg s] . w_j[seg s, c], lo, hi) * mults(i, j)
// over segments s of rows_per_xbar rows (128, 256, 384 or 512; 512 on
// RAELLA's crossbars), input slices i and weight planes j, with x
// (n_i, B, R) and planes (n_j, R, C) int8 of any value and rows past R
// zero on both sides. There is no center term and no counter: it is K1's
// function (csrc/fused_crossbar.cu) on inputs that arrive already sliced.
//
// What bounds it on an H100: the planes' bytes over HBM bandwidth at
// decode batches (2 * n_i int8 operations, multiply and add, a plane byte
// per batch row: 16 at n_i = 8, below the int8 tensor-core ridge of ~590
// a byte up to B ~ 37); at B = 64 with 8 slices, the int8 operations. A
// small projection is one launch and a few HBM round trips.
//
// Design: the int8 mma.sync GEMM of bitplane_gemm.cuh (which says what its
// staging, fragments and cluster reduction do about those bounds), with
// the slice operand bitplane::SlicesX in place of K1's bit planes: column g
// of a batch row's n8 tile is input slice g, one 32-bit word of the slice
// as it lies in memory per B register, so the 8 accumulators of one (b, c)
// per (segment, plane) are the slice column sums themselves, and the
// epilogue below clamps each and multiplies it by mults(i, j). Planes are
// staged at stride R with the rows past R zero-filled by cp.async's
// src-size, so a call pads nothing; the (segment, plane) pairs are split
// across a cluster and reduced in distributed shared memory, so each
// output element is written once and no call zeroes its output. The
// epilogue has no counters: it takes no counts buffer and leaves K1's and
// K2's alone. |d| <= 512 * 128 * 128 fits s32; contributions wrap modulo
// 2^32 like the reference's int32.

#include "bitplane_gemm.cuh"

namespace {

using namespace bitplane;

// One (b, c)'s contribution for one (segment, plane): per input slice its
// column sum d[i], clamped, times mults(i, j). No counters.
struct SlicedEpilogue {
  static constexpr int SLOTS = 0;
  int n_i, lo, hi;

  __device__ __forceinline__ uint32_t operator()(const int (&d)[BITS], bool,
                                                 const int32_t* mj) const {
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) {
      if (i >= n_i) break;
      acc += (uint32_t)clampi(d[i], lo, hi) * (uint32_t)mj[i * MAX_J];
    }
    return acc;
  }
};

template <int BT, int SUBS, bool VEC>
__global__ void __launch_bounds__(THREADS) sliced_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, int32_t* __restrict__ out, int B,
    int R, int C, int n_seg, int n_j, int ppr, int n_i, int lo, int hi) {
  SlicedEpilogue epi{n_i, lo, hi};
  gemm<BT, SUBS, VEC, SlicesX>(x, w, mults, nullptr, out, nullptr, nullptr,
                               B, R, C, n_seg, n_j, ppr, n_i, epi);
}

template <bool VEC>
cudaError_t launch_plan(const int8_t* x, const int8_t* w, const int32_t* m,
                        int32_t* out, int B, int R, int C, int n_seg,
                        int rows, int n_j, int n_i, int lo, int hi, int bt,
                        int cluster, int ppr, cudaStream_t st) {
  return dispatch(bt, rows, [&](auto bt_c, auto subs_c) {
    constexpr int BT = decltype(bt_c)::value, SUBS = decltype(subs_c)::value;
    static bool attr = false;  // one attribute call per instantiation
    return launch<BT, SlicesX>(sliced_kernel<BT, SUBS, VEC>, attr, B, C,
                               cluster, st, x, w, m, out, B, R, C, n_seg, n_j,
                               ppr, n_i, lo, hi);
  });
}

}  // namespace

// x (n_i, B, R) int8; w (n_j, R, C) int8; mults (n_i, n_j) int32; out
// (B, C) int32, every element written once. rows is the segment length
// (128, 256, 384 or 512) and n_seg = ceil(R / rows). The
// tile plan is checked against the header's constants
// (bitplane::plan_ok<SlicesX>). Operands whose rows all start 16-byte
// aligned (R and C multiples of 16) take the cp.async path, others the
// word-load path. Returns the launch's cudaError_t.
extern "C" int sliced_crossbar_launch(
    const void* x, const void* w, const void* mults, void* out, int B, int R,
    int C, int n_seg, int rows, int n_j, int n_i, int adc_lo, int adc_hi,
    int bn, int bk, int stages, int bt, int cluster, int ppr, int smem,
    void* stream) {
  if (n_i < 1 || n_i > MAX_I || (long long)(n_seg - 1) * rows >= R ||
      !plan_ok<SlicesX>(B, R, C, n_seg, rows, n_j, bn, bk, stages, bt,
                        cluster, ppr, smem))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* mp = static_cast<const int32_t*>(mults);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(vec_ok<SlicesX>(x, w, R, C)
                   ? launch_plan<true>(xp, wp, mp, op, B, R, C, n_seg, rows,
                                       n_j, n_i, adc_lo, adc_hi, bt, cluster,
                                       ppr, st)
                   : launch_plan<false>(xp, wp, mp, op, B, R, C, n_seg, rows,
                                        n_j, n_i, adc_lo, adc_hi, bt, cluster,
                                        ppr, st));
}

extern "C" const char* sliced_crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
