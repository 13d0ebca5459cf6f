// The static-slicing exact datapath over 512-row crossbar segments
// (paper §4.1.4, §5.1; the datapath Algorithm 1 measures, §4.2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_crossbar.py
// (fused_crossbar / _kernel). Plain version:
// repro_torch/kernels/ref.py::fused_crossbar. Tile plan (batch tile,
// cluster size, (segment, plane) pairs per rank, shared memory, grid):
// bitplane.py::tile_plan, through fused_crossbar.py::tile_plan.
//
// What it computes, per output (b, c):
//   psum = sum_s xsum(b, s) * centers(s, c)                   (center term)
//        + sum_{s, i, j} clip(((x >> li) & mask_i) . w_j, lo, hi) * mults(i, j)
// over every segment s, input slice i and weight plane j; a clamp that sits
// on either ADC bound is a saturation, counted over the true (B, C) extent.
//
// Every input slice's column sum is linear in the input bits: with the 8
// bit-plane dots d[p] = bit_p(x) . w_j it is sum_q d[li + q] << q over the
// set bits q of mask_i -- d[li] itself for Algorithm 1's 1b slices, a
// shifted sum for (4,2,2) or (8,). So the kernel is the bit-plane int8 GEMM
// of bitplane_gemm.cuh (which says what bounds it on an H100 and what its
// design does about it) with a short epilogue: per input slice the shifted
// sum in int32 (at most 255 * 512 * 128 in magnitude, so exact), one clamp,
// one saturation count and one multiply by mults in uint32. It has no
// speculation, recovery or select, so its epilogue holds fewer registers
// than K2's. A zero plane (the padding of a ragged plan, mults 0) clamps to
// 0 and counts no saturation while the ADC window holds 0.
//
// Algorithm 1 calls it at B = 16, where the 4-row batch tile has 4 blocks
// read each plane tile (once from HBM, then from L2). Forced 2- and 1-row
// tiles ran slower at all four qwen1.5-0.5b site shapes on an H100 (head:
// 0.73 ms at 4 rows, 1.05 at 2, 1.78 at 1): the plane tile's transpose and
// the per-pair barriers, paid once per block, weigh more than the L2
// re-reads. 8-row tiles are out for K2's reason: 128 accumulators a thread.

#include "bitplane_gemm.cuh"

namespace {

using namespace bitplane;

// The input slices' weights per bit (bitplane::slice_weights). Indexed by
// compile-time constants only, so they stay in the constant bank.
struct Tables {
  int n_i;
  int sw[MAX_I][BITS];
};

// One (b, c)'s contribution for one (segment, plane): per input slice the
// shifted sum, the clamp, the saturation count (only where ok, inside the
// true (B, C) extent) and the multiply by mults(i, j). One counter.
struct CrossbarEpilogue {
  static constexpr int SLOTS = 1;
  const Tables& tab;
  int lo, hi;
  unsigned sats;

  __device__ __forceinline__ CrossbarEpilogue(const Tables& t, int lo_,
                                              int hi_)
      : tab(t), lo(lo_), hi(hi_), sats(0u) {}

  __device__ __forceinline__ uint32_t operator()(const int (&d)[BITS], bool ok,
                                                 const int32_t* mj) {
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) {
      if (i >= tab.n_i) break;
      int v = 0;
#pragma unroll
      for (int p = 0; p < BITS; ++p) v += d[p] * tab.sw[i][p];
      const int cs = clampi(v, lo, hi);
      sats += (ok && (cs == lo || cs == hi)) ? 1u : 0u;
      acc += (uint32_t)cs * (uint32_t)mj[i * MAX_J];
    }
    return acc;
  }

  template <class Add>
  __device__ __forceinline__ void count(Add&& add) { add(sats, 0); }
  __device__ __forceinline__ int slots() const { return SLOTS; }
};

template <int BT, bool VEC>
__global__ void __launch_bounds__(THREADS) crossbar_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, const int32_t* __restrict__ centers,
    int32_t* __restrict__ out, unsigned long long* __restrict__ counts,
    unsigned long long* __restrict__ next_counts, int B, int R, int C,
    int n_seg, int n_j, int ppr, int lo, int hi,
    const __grid_constant__ Tables tab) {
  CrossbarEpilogue epi(tab, lo, hi);
  gemm<BT, VEC>(x, w, mults, centers, out, counts, next_counts, B, R, C,
                n_seg, n_j, ppr, tab.n_i, epi);
}

template <bool VEC>
cudaError_t launch_bt(const int32_t* x, const int8_t* w, const int32_t* m,
                      const int32_t* c, int32_t* out,
                      unsigned long long* counts, unsigned long long* next,
                      int B, int R, int C, int n_seg, int n_j, int lo, int hi,
                      const Tables& tab, int bt, int cluster, int ppr,
                      cudaStream_t st) {
  static bool attr[3] = {};  // one attribute call per instantiation
  switch (bt) {
    case 1: return launch<1>(crossbar_kernel<1, VEC>, attr[0], B, C, cluster, st, x, w, m, c, out, counts, next, B, R, C, n_seg, n_j, ppr, lo, hi, tab);
    case 2: return launch<2>(crossbar_kernel<2, VEC>, attr[1], B, C, cluster, st, x, w, m, c, out, counts, next, B, R, C, n_seg, n_j, ppr, lo, hi, tab);
    case 4: return launch<4>(crossbar_kernel<4, VEC>, attr[2], B, C, cluster, st, x, w, m, c, out, counts, next, B, R, C, n_seg, n_j, ppr, lo, hi, tab);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, R) int32 codes 0..255; w (n_j, n_seg*512, C) int8; mults (n_i, n_j)
// int32; centers (n_seg, C) int32; out (B, C) int32, every element written
// once; counts (1,) int64, the saturations, zero before the launch: blocks
// add into it; next_counts (1,) int64, which the launch zeroes for the
// next launch of this kernel on the stream.
// li / mask (n_i,) are host tables; li + (bits of mask) <= 8 (the 8 bit
// planes are all the kernel computes), else the launch is refused.
// The tile plan is checked against the header's constants
// (bitplane::plan_ok). Operands whose rows all start 16-byte aligned take
// the cp.async path, others the word-load path. Returns the launch's
// cudaError_t.
extern "C" int fused_crossbar_launch(
    const void* x, const void* w, const void* mults, const void* centers,
    void* out, void* counts, void* next_counts, int B, int R, int C,
    int n_seg, int n_j, int n_i, const int* li, const int* mask, int adc_lo,
    int adc_hi, int bn, int bk, int stages, int bt, int cluster, int ppr,
    int smem, void* stream) {
  if (n_i < 1 || n_i > MAX_I ||
      !plan_ok(B, R, C, n_seg, n_j, bn, bk, stages, bt, cluster, ppr, smem))
    return (int)cudaErrorInvalidValue;
  Tables tab{};
  tab.n_i = n_i;
  if (!slice_weights(n_i, li, mask, tab.sw)) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* mp = static_cast<const int32_t*>(mults);
  const auto* cp = static_cast<const int32_t*>(centers);
  auto* op = static_cast<int32_t*>(out);
  auto* kp = static_cast<unsigned long long*>(counts);
  auto* nk = static_cast<unsigned long long*>(next_counts);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(vec_ok(x, w, R, C)
                   ? launch_bt<true>(xp, wp, mp, cp, op, kp, nk, B, R, C,
                                     n_seg, n_j, adc_lo, adc_hi, tab, bt,
                                     cluster, ppr, st)
                   : launch_bt<false>(xp, wp, mp, cp, op, kp, nk, B, R, C,
                                      n_seg, n_j, adc_lo, adc_hi, tab, bt,
                                      cluster, ppr, st));
}

extern "C" const char* fused_crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
