// The forms of the K1/K4 partition search that PR 16's measurements
// compared (PERF.md), for tools/partition_ab.py to time beside the port's
// own kernel (csrc/lanes_sort.cu merge_partition_kernel). Not part of the
// port's path: nothing in the package builds or loads this file.
//
// Every form computes, for each block boundary b, the merge-path split of
// its run pair's diagonal d: the largest i in [lo, hi] with
// !(B[d - i] < A[i - 1]), compared by (key rows, tie-break row).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// word by word: one dependent load pair a compared word
__device__ __forceinline__ bool lt_words(const uint32_t* __restrict__ x,
                                         size_t n, int nk, int tb_row,
                                         size_t a, size_t b) {
  for (int w = 0; w < nk; ++w) {
    const uint32_t u = __ldg(x + (size_t)w * n + a);
    const uint32_t v = __ldg(x + (size_t)w * n + b);
    if (u != v) return u < v;
  }
  return __ldg(x + (size_t)tb_row * n + a) < __ldg(x + (size_t)tb_row * n + b);
}

struct Pair {
  size_t a_base, b_base, d, lo, hi;
};

__device__ __forceinline__ Pair pair_of(size_t b, int width, size_t L) {
  Pair p;
  const size_t out0 = b * width;
  p.a_base = out0 / (2 * L) * (2 * L);
  p.b_base = p.a_base + L;
  p.d = out0 - p.a_base;
  p.lo = p.d > L ? p.d - L : 0;
  p.hi = p.d < L ? p.d : L;
  return p;
}

// PR 2's kernel: one thread a boundary, a binary search at the midpoint.
__global__ void part_binary(const uint32_t* __restrict__ x,
                            uint32_t* __restrict__ splits, size_t n, int nk,
                            int tb_row, int width, size_t run_len,
                            size_t blocks) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  Pair p = pair_of(b, width, run_len);
  while (p.lo < p.hi) {
    const size_t mid = (p.lo + p.hi + 1) / 2;
    if (!lt_words(x, n, nk, tb_row, p.b_base + p.d - mid, p.a_base + mid - 1))
      p.lo = mid;
    else
      p.hi = mid - 1;
  }
  splits[b] = (uint32_t)p.lo;
}

// G lanes a boundary (32 / G boundaries a warp), G candidates a round, the
// first false one found by __ballot_sync: evenly spaced in the range
// (ALIGNED false) or on a power-of-two grid (ALIGNED true). G = 32 is the
// warp-per-boundary search.
template <int G, bool ALIGNED>
__global__ void part_group(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ splits, size_t n, int nk,
                           int tb_row, int width, size_t run_len,
                           size_t blocks) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int gl = lane % G;
  const size_t b =
      (((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / G) + grp;
  Pair p = pair_of(b < blocks ? b : 0, width, run_len);
  if (b >= blocks) p.lo = p.hi = 0;
  const unsigned mine = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (grp * G);
  while (__any_sync(0xffffffffu, p.lo < p.hi)) {
    const size_t span = p.hi - p.lo;
    int sh = 0;
    while (((size_t)G << sh) <= span) ++sh;
    const size_t base = p.lo >> sh;
    auto cand = [&](int l) -> size_t {
      if (ALIGNED) return (base + 1 + l) << sh;
      return span >= (size_t)G ? p.lo + ((size_t)(l + 1) * span + G - 1) / G
                               : p.lo + 1 + l;
    };
    const size_t c = cand(gl);
    const bool ok = p.lo < p.hi && c <= p.hi &&
                    !lt_words(x, n, nk, tb_row, p.b_base + p.d - c,
                              p.a_base + c - 1);
    const int t = __popc(__ballot_sync(0xffffffffu, ok) & mine);
    if (p.lo < p.hi) {
      const size_t nlo = t ? cand(t - 1) : p.lo;
      const size_t nhi = t < G ? cand(t) - 1 : p.hi;
      p.lo = nlo;
      p.hi = nhi < p.hi ? nhi : p.hi;
    }
  }
  if (gl == 0 && b < blocks) splits[b] = (uint32_t)p.lo;
}

// The port's search on the power-of-two grid, with the word-by-word
// compare (the port's kernel batches the words after an equal first word).
__global__ void part_grid_words(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ splits, size_t n,
                                int nk, int tb_row, int width,
                                size_t run_len, size_t blocks) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  Pair p = pair_of(b, width, run_len);
  while (p.lo < p.hi) {
    const int sh = 63 - __clzll((long long)(p.hi - p.lo));
    const size_t c = ((p.lo >> sh) + 1) << sh;
    if (!lt_words(x, n, nk, tb_row, p.b_base + p.d - c, p.a_base + c - 1))
      p.lo = c;
    else
      p.hi = c - 1;
  }
  splits[b] = (uint32_t)p.lo;
}

}  // namespace

extern "C" {

// form: 0 PR 2's binary search, 1 a warp a boundary with 32 evenly spaced
// candidates, 2 the same on the power-of-two grid, 3 four lanes a boundary
// on the grid, 4 one thread a boundary on the grid, word by word.
int partition_ab(int form, const void* x, void* splits, size_t n, int nk,
                 int tb_row, int width, size_t run_len, void* stream) {
  const size_t blocks = n / width;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* xx = (const uint32_t*)x;
  uint32_t* sp = (uint32_t*)splits;
  const unsigned threads = 256;
  const unsigned by_thread = (unsigned)((blocks + threads - 1) / threads);
  const unsigned by_warp = (unsigned)((blocks + 7) / 8);
  const unsigned by_quad = (unsigned)((blocks + 63) / 64);
  switch (form) {
    case 0: part_binary<<<by_thread, threads, 0, s>>>(
        xx, sp, n, nk, tb_row, width, run_len, blocks); break;
    case 1: part_group<32, false><<<by_warp, threads, 0, s>>>(
        xx, sp, n, nk, tb_row, width, run_len, blocks); break;
    case 2: part_group<32, true><<<by_warp, threads, 0, s>>>(
        xx, sp, n, nk, tb_row, width, run_len, blocks); break;
    case 3: part_group<4, true><<<by_quad, threads, 0, s>>>(
        xx, sp, n, nk, tb_row, width, run_len, blocks); break;
    case 4: part_grid_words<<<by_thread, threads, 0, s>>>(
        xx, sp, n, nk, tb_row, width, run_len, blocks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
