// Speculation + recovery over crossbar segments of 128 to 512 rows (paper
// §4.3; 512 on RAELLA's crossbars; bitplane::dispatch picks the
// instantiation).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_spec_crossbar.py
// (fused_spec_crossbar / _kernel). Plain version:
// repro_torch/kernels/ref.py::fused_spec_crossbar. Tile plan (batch tile,
// cluster size, (segment, plane) pairs per rank, shared memory, grid):
// bitplane.py::tile_plan, through fused_spec_crossbar.py::tile_plan.
//
// What it computes, per output (b, c):
//   psum = sum_s xsum(b, s) * centers(s, c)                   (center term)
//        + sum_{s, i, j} value(b, c, s, i, j) * mults(i, j)
// where for every segment s, spec slice i and weight plane j the
// speculative column sum cs = clip(((x >> li) & mask_i) . w_j, lo, hi)
// "fails" when it sits on either ADC bound, and then value is the 1b
// recovery recombination sum_t clip(bit_{li+t}(x) . w_j, lo, hi) *
// rmults(i, t); otherwise value = cs. Failures are counted per spec slice,
// recovery saturations only where recovery ran (rmults > 0, spec failed),
// both masked to the true (B, C) extent.
//
// Every speculative and every recovery dot is a linear combination of the
// 8 bit-plane dots, so the kernel is the bit-plane int8 GEMM of
// bitplane_gemm.cuh (which says what bounds it on an H100 and what its
// design does about it) with the epilogue below. The MMA work does not
// depend on how often speculation fails: a 7b-ADC call does the same as a
// 24b one, and only the epilogue's recovery sums run where a conversion
// failed. In K2 a batch tile of 8 rows took a thread to 255 registers and
// ran slower at B = 64 than twice as many 4-row tiles.

#include "bitplane_gemm.cuh"

namespace {

using namespace bitplane;

constexpr int MAX_W = 8;  // recovery unroll length

// Per spec slice i and input bit p: the speculative weight of the bit
// (bitplane::slice_weights) and the recovery multiplier of bit p
// (rmults(i, p - li) inside the unroll, else 0).
// Indexed by compile-time constants only, so they stay in the constant bank.
struct Tables {
  int n_i;
  int sw[MAX_I][BITS];
  int rmb[MAX_I][BITS];
};

// One (b, c)'s value for one (segment, plane): speculation, clamp, failure
// count, 1b recovery where it failed, select, times mults(i, j); counters
// only where ok (inside the true (B, C) extent). Counters: n_i failures,
// then the recovery saturations.
struct SpecEpilogue {
  static constexpr int SLOTS = MAX_I + 1;
  const Tables& tab;
  int lo, hi;
  unsigned fails[MAX_I];
  unsigned rsats;

  __device__ __forceinline__ SpecEpilogue(const Tables& t, int lo_, int hi_)
      : tab(t), lo(lo_), hi(hi_), rsats(0u) {
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) fails[i] = 0u;
  }

  __device__ __forceinline__ uint32_t operator()(const int (&d)[BITS], bool ok,
                                                 const int32_t* mj) {
    int rcs[BITS];
    bool rsat[BITS];
#pragma unroll
    for (int p = 0; p < BITS; ++p) {
      rcs[p] = clampi(d[p], lo, hi);
      rsat[p] = rcs[p] == lo || rcs[p] == hi;
    }
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) {
      if (i >= tab.n_i) break;
      int spec = 0;
#pragma unroll
      for (int p = 0; p < BITS; ++p) spec += d[p] * tab.sw[i][p];
      const int cs = clampi(spec, lo, hi);
      uint32_t value = (uint32_t)cs;
      if (cs == lo || cs == hi) {  // failed: the slice's 1b recovery
        fails[i] += ok ? 1u : 0u;
        value = 0u;
#pragma unroll
        for (int p = 0; p < BITS; ++p) {
          value += (uint32_t)rcs[p] * (uint32_t)tab.rmb[i][p];
          rsats += (ok && rsat[p] && tab.rmb[i][p] > 0) ? 1u : 0u;
        }
      }
      acc += value * (uint32_t)mj[i * MAX_J];
    }
    return acc;
  }

  template <class Add>
  __device__ __forceinline__ void count(Add&& add) {
#pragma unroll
    for (int i = 0; i < MAX_I; ++i)
      if (i < tab.n_i) add(fails[i], i);
    add(rsats, tab.n_i);
  }
  __device__ __forceinline__ int slots() const { return tab.n_i + 1; }
};

template <int BT, int SUBS, bool VEC>
__global__ void __launch_bounds__(THREADS) spec_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, const int32_t* __restrict__ centers,
    int32_t* __restrict__ out, unsigned long long* __restrict__ counts,
    unsigned long long* __restrict__ next_counts, int B, int R, int C,
    int n_seg, int n_j, int ppr, int lo, int hi,
    const __grid_constant__ Tables tab) {
  SpecEpilogue epi(tab, lo, hi);
  gemm<BT, SUBS, VEC, CodesX>(x, w, mults, centers, out, counts,
                              next_counts, B, R, C, n_seg, n_j, ppr, tab.n_i,
                              epi);
}

template <bool VEC>
cudaError_t launch_plan(const int32_t* x, const int8_t* w, const int32_t* m,
                        const int32_t* c, int32_t* out,
                        unsigned long long* counts, unsigned long long* next,
                        int B, int R, int C, int n_seg, int rows, int n_j,
                        int lo, int hi, const Tables& tab, int bt,
                        int cluster, int ppr, cudaStream_t st) {
  return dispatch(bt, rows, [&](auto bt_c, auto subs_c) {
    constexpr int BT = decltype(bt_c)::value, SUBS = decltype(subs_c)::value;
    static bool attr = false;  // one attribute call per instantiation
    return launch<BT, CodesX>(spec_kernel<BT, SUBS, VEC>, attr, B, C,
                              cluster, st, x, w, m, c, out, counts, next, B,
                              R, C, n_seg, n_j, ppr, lo, hi, tab);
  });
}

}  // namespace

// x (B, R) int32 codes; w (n_j, n_seg*rows, C) int8, rows (the segment
// length) 128, 256, 384 or 512; mults (n_i, n_j) int32;
// centers (n_seg, C) int32; out (B, C) int32, every element written once;
// counts (n_i + 1,) int64 (failures per spec slice, then recovery
// saturations), zero before the launch: blocks add into it; next_counts
// (MAX_I + 1,) int64, which the launch zeroes for the next launch on the
// stream.
// li / mask (n_i,) and rmults (n_i, max_w) are host tables; li + (bits of
// mask) <= 8 and rmults(i, t) == 0 where li + t >= 8 (the 8 bit planes are
// all the kernel computes), else the launch is refused.
// The tile plan is checked against the header's constants
// (bitplane::plan_ok). Operands whose rows all start 16-byte aligned take
// the cp.async path, others the word-load path. Returns the launch's
// cudaError_t.
extern "C" int fused_spec_crossbar_launch(
    const void* x, const void* w, const void* mults, const void* centers,
    void* out, void* counts, void* next_counts, int B, int R, int C,
    int n_seg, int rows, int n_j, int n_i, int max_w, const int* li,
    const int* mask, const int* rmults, int adc_lo, int adc_hi, int bn, int bk,
    int stages, int bt, int cluster, int ppr, int smem, void* stream) {
  if (n_i < 1 || n_i > MAX_I || max_w < 1 || max_w > MAX_W ||
      !plan_ok<CodesX>(B, R, C, n_seg, rows, n_j, bn, bk, stages, bt, cluster,
                       ppr, smem))
    return (int)cudaErrorInvalidValue;
  Tables tab{};
  tab.n_i = n_i;
  if (!slice_weights(n_i, li, mask, tab.sw)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_i; ++i) {
    for (int t = 0; t < max_w; ++t)
      if (rmults[i * max_w + t] != 0 && li[i] + t >= BITS)
        return (int)cudaErrorInvalidValue;
    for (int p = 0; p < BITS; ++p) {
      const int q = p - li[i];
      tab.rmb[i][p] = (q >= 0 && q < max_w) ? rmults[i * max_w + q] : 0;
    }
  }
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* mp = static_cast<const int32_t*>(mults);
  const auto* cp = static_cast<const int32_t*>(centers);
  auto* op = static_cast<int32_t*>(out);
  auto* kp = static_cast<unsigned long long*>(counts);
  auto* nk = static_cast<unsigned long long*>(next_counts);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(vec_ok<CodesX>(x, w, R, C)
                   ? launch_plan<true>(xp, wp, mp, cp, op, kp, nk, B, R, C,
                                       n_seg, rows, n_j, adc_lo, adc_hi, tab,
                                       bt, cluster, ppr, st)
                   : launch_plan<false>(xp, wp, mp, cp, op, kp, nk, B, R, C,
                                        n_seg, rows, n_j, adc_lo, adc_hi, tab,
                                        bt, cluster, ppr, st));
}

extern "C" const char* fused_spec_crossbar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
