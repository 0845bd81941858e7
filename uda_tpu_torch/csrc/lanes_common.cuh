// The device code of the lanes-layout sort kernels, shared by K2/K1
// (lanes_sort.cu, every row layout) and K3/K4 (lanes_fold.cu, the slim
// [4, n] layout): the tile sort, the merge partition and the merge pass,
// with their launch structs and plane dispatch. Each source includes it
// into one translation unit; all of it is internal to that unit.
//
// Layout: uint32[rows, n], row-major. Row r holds word r of every record;
// record i is column i. Rows [0, nk) are the key words, row tb_row is the
// stability tie-break (the global arrival index, written by the tile sort),
// every other row is payload. All global offsets are size_t: a 32-row call
// at n = 2^27 holds 2^32 words, past any int index.
//
// Order: (key words..., tie-break), each word compared as UNSIGNED 32-bit.
// The tie-break makes every record distinct, so the kernels reproduce the
// stable order exactly and have one correct output; ties that remain (only
// in inputs with repeated tie-break words) go to the first run.
//
// Compared words live in shared memory packed two to a 64-bit word, most
// significant first (word 2q in the high half of u64 q, word 2q+1 in the low
// half, zero past the last), as P "planes" of u64, one element per record.
// A compare is P 64-bit compares with an early exit, and almost always ends
// at plane 0. Plane element k sits at k + k/16: a warp reading records at a
// power-of-two stride up to 16 then touches distinct banks.
//
// Row layout of a launch: the kernels take template parameters <P, R, NK,
// TB>. R = 0 reads rows, nk and tb_row from the arguments at run time (the
// form lanes_sort.cu instantiates); R > 0 fixes all three at compile time
// (R rows, NK key words, tie-break row TB), which the compiler folds into
// the row loops and the payload mapping.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Plane index of record k (one pad element per 16).
__device__ __forceinline__ int sk64(int k) { return k + (k >> 4); }
// Index of uint16 element k (two pad elements per 64).
__device__ __forceinline__ int sk16(int k) { return k + ((k >> 6) << 1); }

__device__ __forceinline__ int half_shift(int w) { return (w & 1) ? 0 : 32; }

// Packed compared words of record c: key words from rows [0, nk) and `tbv`
// as word nk.
template <int P>
__device__ __forceinline__ void pack_rec(uint64_t (&rec)[P],
                                         const uint32_t* __restrict__ x,
                                         size_t n, int nk, size_t c,
                                         uint32_t tbv) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int w0 = 2 * q;
    const int w1 = 2 * q + 1;
    const uint32_t hi = w0 < nk ? __ldg(x + (size_t)w0 * n + c)
                                : (w0 == nk ? tbv : 0u);
    const uint32_t lo = w1 < nk ? __ldg(x + (size_t)w1 * n + c)
                                : (w1 == nk ? tbv : 0u);
    rec[q] = ((uint64_t)hi << 32) | lo;
  }
}

template <int P>
__device__ __forceinline__ void load_rec(uint64_t (&rec)[P],
                                         const uint64_t* s, int ps, int k) {
#pragma unroll
  for (int q = 0; q < P; ++q) rec[q] = s[q * ps + sk64(k)];
}

template <int P>
__device__ __forceinline__ void store_rec(uint64_t* s, int ps, int k,
                                          const uint64_t (&rec)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) s[q * ps + sk64(k)] = rec[q];
}

template <int P>
__device__ __forceinline__ bool rec_lt(const uint64_t (&a)[P],
                                       const uint64_t (&b)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (a[q] != b[q]) return a[q] < b[q];
  return false;
}

// Record a < record b, both in shared memory; reads past plane 0 only on
// equal high words.
template <int P>
__device__ __forceinline__ bool smem_lt(const uint64_t* s, int ps, int a,
                                        int b) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint64_t u = s[q * ps + sk64(a)];
    const uint64_t v = s[q * ps + sk64(b)];
    if (u != v) return u < v;
  }
  return false;
}

// Record a < record b in global memory, by (key rows, tie-break row).
__device__ __forceinline__ bool global_lt(const uint32_t* __restrict__ x,
                                          size_t n, int nk, int tb_row,
                                          size_t a, size_t b) {
  for (int w = 0; w < nk; ++w) {
    const uint32_t u = __ldg(x + (size_t)w * n + a);
    const uint32_t v = __ldg(x + (size_t)w * n + b);
    if (u != v) return u < v;
  }
  return __ldg(x + (size_t)tb_row * n + a) < __ldg(x + (size_t)tb_row * n + b);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Number of u64 planes for nk key words plus the tie-break: ceil((nk+1)/2),
// rounded up to an instantiated count (zero planes compare equal); 0 for a
// key count the kernels do not take (outside 1..31).
constexpr int planes_of(int nk) {
  const int p = (nk + 2) / 2;
  if (nk < 1 || p > 16) return 0;
  return p <= 4 ? p : (p <= 8 ? 8 : 16);
}

// F<planes_of(nk), 0, 0, 0>::run(a...) (the run-time row layout), or
// `none` for a key count no kernel takes: the one place a launcher or a
// query of lanes_sort.cu picks its instantiation.
template <template <int, int, int, int> class F, typename R, typename... A>
R dispatch_planes(int nk, R none, A... a) {
  switch (planes_of(nk)) {
    case 1: return F<1, 0, 0, 0>::run(a...);
    case 2: return F<2, 0, 0, 0>::run(a...);
    case 3: return F<3, 0, 0, 0>::run(a...);
    case 4: return F<4, 0, 0, 0>::run(a...);
    case 8: return F<8, 0, 0, 0>::run(a...);
    case 16: return F<16, 0, 0, 0>::run(a...);
    default: return none;
  }
}

inline int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ------------------------------------------------------------- tile sort

// Records per thread (V) and the most threads a block may have (LB) for P
// planes: V * P u64 stay in registers, and LB bounds the registers the
// compiler may take so every tile the shared memory admits can launch.
template <int P> struct K2Cfg;
template <> struct K2Cfg<1> { static constexpr int V = 16, LB = 1024; };
template <> struct K2Cfg<2> { static constexpr int V = 8, LB = 1024; };
template <> struct K2Cfg<3> { static constexpr int V = 8, LB = 1024; };
template <> struct K2Cfg<4> { static constexpr int V = 8, LB = 512; };
template <> struct K2Cfg<8> { static constexpr int V = 4, LB = 512; };
template <> struct K2Cfg<16> { static constexpr int V = 4, LB = 256; };

inline size_t tile_sort_smem(int nk, int tile) {
  return (size_t)planes_of(nk) * (tile + tile / 16) * sizeof(uint64_t);
}

// The tile sort (K2, K3): one block of tile / V threads per tile of `tile`
// records.
// 1. Coalesced load of the key rows into the planes; word nk is the local
//    arrival index, which also names each record's source column.
// 2. Each thread sorts its V consecutive records in registers (odd-even
//    transposition network, no barrier).
// 3. Rounds: sorted runs of `width` merge pairwise into runs of 2 * width.
//    Each thread writes its V records back, then finds where its V outputs
//    start in its run pair (merge-path binary search in shared memory) and
//    merges them serially from two register heads.
// 4. Every row of the tile is written once, coalesced: key rows from the
//    planes, the tie-break as base + local index, payload rows gathered by
//    the local index within the tile's span.
template <int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K2Cfg<P>::LB)
    tile_sort_kernel(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ out, size_t n, int rows_arg,
                     int nk_arg, int tb_arg, int tile) {
  constexpr int V = K2Cfg<P>::V;
  const int rows = R ? R : rows_arg;
  const int nk = R ? NK : nk_arg;
  const int tb_row = R ? TB : tb_arg;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  uint64_t* s = reinterpret_cast<uint64_t*>(sm_raw);
  const int ps = tile + (tile >> 4);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // == tile / V
  const size_t base = (size_t)blockIdx.x * tile;

#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int k = tid + j * nt;
    uint64_t rec[P];
    pack_rec<P>(rec, x, n, nk, base + k, (uint32_t)k);
    store_rec<P>(s, ps, k, rec);
  }
  __syncthreads();

  uint64_t r[V][P];
#pragma unroll
  for (int v = 0; v < V; ++v) load_rec<P>(r[v], s, ps, tid * V + v);
#pragma unroll
  for (int p = 0; p < V; ++p) {
#pragma unroll
    for (int i = p & 1; i + 1 < V; i += 2) {
      if (rec_lt<P>(r[i + 1], r[i])) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint64_t t = r[i][q];
          r[i][q] = r[i + 1][q];
          r[i + 1][q] = t;
        }
      }
    }
  }

  for (int width = V; width < tile; width <<= 1) {
    __syncthreads();  // every thread has read the previous layout
#pragma unroll
    for (int v = 0; v < V; ++v) store_rec<P>(s, ps, tid * V + v, r[v]);
    __syncthreads();
    const int g = tid * V;
    const int d = g & (2 * width - 1);  // diagonal within the run pair
    const int a0 = g - d;
    const int b0 = a0 + width;
    int lo = d > width ? d - width : 0;
    int hi = d < width ? d : width;
    while (lo < hi) {  // largest i with A[i-1] <= B[d-i]
      const int mid = (lo + hi + 1) >> 1;
      if (!smem_lt<P>(s, ps, b0 + d - mid, a0 + mid - 1)) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    int ia = lo;
    int ib = d - lo;
    uint64_t ha[P], hb[P];
    if (ia < width) load_rec<P>(ha, s, ps, a0 + ia);
    if (ib < width) load_rec<P>(hb, s, ps, b0 + ib);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool take_a = ib >= width || (ia < width && !rec_lt<P>(hb, ha));
#pragma unroll
      for (int q = 0; q < P; ++q) r[v][q] = take_a ? ha[q] : hb[q];
      if (take_a) {
        if (++ia < width) load_rec<P>(ha, s, ps, a0 + ia);
      } else {
        if (++ib < width) load_rec<P>(hb, s, ps, b0 + ib);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < V; ++v) store_rec<P>(s, ps, tid * V + v, r[v]);
  __syncthreads();

  const uint64_t* idx_plane = s + (nk >> 1) * ps;
  const int idx_shift = half_shift(nk);
  for (int row = 0; row < rows; ++row) {
    uint32_t* o = out + (size_t)row * n + base;
    if (row < nk) {
      const uint64_t* plane = s + (row >> 1) * ps;
      const int sh = half_shift(row);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = tid + j * nt;
        o[k] = (uint32_t)(plane[sk64(k)] >> sh);
      }
    } else if (row == tb_row) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = tid + j * nt;
        o[k] = (uint32_t)(base + (uint32_t)(idx_plane[sk64(k)] >> idx_shift));
      }
    } else {
      const uint32_t* xr = x + (size_t)row * n + base;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = tid + j * nt;
        o[k] = __ldg(xr + (uint32_t)(idx_plane[sk64(k)] >> idx_shift));
      }
    }
  }
}

template <int P, int R, int NK, int TB> struct TileSortLaunch {
  static int run(const uint32_t* x, uint32_t* out, size_t n, int rows,
                 int nk, int tb_row, int tile, cudaStream_t stream) {
    const int threads = tile / K2Cfg<P>::V;
    if (threads > K2Cfg<P>::LB || threads * K2Cfg<P>::V != tile)
      return (int)cudaErrorInvalidConfiguration;
    const size_t smem = tile_sort_smem(nk, tile);
    const int err = set_smem((const void*)tile_sort_kernel<P, R, NK, TB>,
                             smem);
    if (err) return err;
    tile_sort_kernel<P, R, NK, TB>
        <<<(unsigned)(n / tile), threads, smem, stream>>>(
            x, out, n, rows, nk, tb_row, tile);
    return (int)cudaGetLastError();
  }
};

// The widest power-of-two tile one tile-sort block takes: at most LB
// threads of V records, and its shared memory within smem_limit.
template <int P, int R, int NK, int TB> struct TileSortMaxTile {
  static int run(int nk, size_t smem_limit) {
    int tile = K2Cfg<P>::LB * K2Cfg<P>::V;
    while (tile > K2Cfg<P>::V && tile_sort_smem(nk, tile) > smem_limit)
      tile >>= 1;
    return tile;
  }
};

// ------------------------------------------------- merge pass (K1, K4)

constexpr int K1_V = 8;             // outputs per thread
constexpr int K1_MAX_WIDTH = 4096;  // records per block, at most

inline size_t merge_pass_smem(int rows, int nk, int width) {
  const size_t planes = (size_t)planes_of(nk) * (width + width / 16) * 8;
  const size_t payload = (size_t)(rows - nk - 1) * width * 4;
  const size_t src = (size_t)(width + width / 32 + 2) * 2;
  return planes + payload + src;
}

// A merge pass's block width: the largest power of two up to K1_MAX_WIDTH
// that divides n and 2 * run_len and whose shared memory fits `budget`
// (at least K1_V); 0 for a key count the kernels do not take.
inline int merge_width(int rows, int nk, size_t n, size_t run_len,
                       size_t budget) {
  if (!planes_of(nk)) return 0;
  size_t w = K1_MAX_WIDTH;
  while (w > (size_t)K1_V &&
         (n % w || (2 * run_len) % w ||
          merge_pass_smem(rows, nk, (int)w) > budget))
    w >>= 1;
  return (int)w;
}

// The partition: for every block boundary b (output column b * width), the
// merge-path split of its run pair's diagonal d: i0 = the number of A-run
// records among the pair's first d merged records, ties to A. One thread
// per boundary, a binary search in global memory; the same search and tie
// rule as the plain version's merge_splits.
__global__ void merge_partition_kernel(const uint32_t* __restrict__ x,
                                       uint32_t* __restrict__ splits,
                                       size_t n, int nk, int tb_row,
                                       int width, size_t run_len,
                                       size_t blocks) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const size_t L = run_len;
  const size_t out0 = b * width;
  const size_t a_base = out0 / (2 * L) * (2 * L);
  const size_t b_base = a_base + L;
  const size_t d = out0 - a_base;
  size_t lo = d > L ? d - L : 0;
  size_t hi = d < L ? d : L;
  while (lo < hi) {
    const size_t mid = (lo + hi + 1) / 2;  // candidate: A records taken
    if (!global_lt(x, n, nk, tb_row, b_base + d - mid, a_base + mid - 1)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  splits[b] = (uint32_t)lo;
}

// The merge pass (K1, K4): one block of width / K1_V threads per `width`
// output records of one pass, which merges adjacent ascending runs of
// run_len into ascending runs of 2 * run_len. The block's ends come from
// the partition: it merges A[i0, i1) with B[j0, j1), i1 - i0 + j1 - j0 =
// width.
// 1. Load: payload rows by cp.async into row-major shared memory, compared
//    words packed into the planes; window position k < na is A[i0 + k],
//    k >= na is B[j0 + k - na]. Every word is read once, coalesced.
// 2. Merge: thread t owns outputs [t V, t V + V): one binary search for its
//    diagonal, then V serial steps from register heads, recording each
//    output's window position.
// 3. Store: every row written once, coalesced, from shared memory.
template <int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K1_MAX_WIDTH / K1_V)
    merge_pass_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ splits, size_t n,
                      int rows_arg, int nk_arg, int tb_arg, int width,
                      size_t run_len) {
  const int rows = R ? R : rows_arg;
  const int nk = R ? NK : nk_arg;
  const int tb_row = R ? TB : tb_arg;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int W = width;
  const int ps = W + (W >> 4);
  const int npay = rows - nk - 1;
  uint64_t* s = reinterpret_cast<uint64_t*>(sm_raw);
  uint32_t* pay = reinterpret_cast<uint32_t*>(s + (size_t)P * ps);
  uint16_t* src = reinterpret_cast<uint16_t*>(pay + (size_t)npay * W);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // == W / K1_V
  const size_t L = run_len;
  const size_t out0 = (size_t)blockIdx.x * W;
  const size_t a_base = out0 / (2 * L) * (2 * L);
  const size_t d0 = out0 - a_base;
  const size_t i0 = splits[blockIdx.x];
  const size_t i1 = d0 + W == 2 * L ? L : splits[blockIdx.x + 1];
  const int na = (int)(i1 - i0);
  const int nb = W - na;
  const size_t a_col = a_base + i0;                   // column of k = 0
  const size_t b_col = a_base + L + (d0 - i0) - na;   // + k for k >= na

  for (int p = 0; p < npay; ++p) {
    const int row = p < tb_row - nk ? nk + p : nk + 1 + p;
    const uint32_t* xr = x + (size_t)row * n;
    uint32_t* dst = pay + (size_t)p * W;
#pragma unroll
    for (int j = 0; j < K1_V; ++j) {
      const int k = tid + j * nt;
      cp_async4(dst + k, xr + (k < na ? a_col : b_col) + k);
    }
  }
  const uint32_t* xtb = x + (size_t)tb_row * n;
#pragma unroll
  for (int j = 0; j < K1_V; ++j) {
    const int k = tid + j * nt;
    const size_t c = (k < na ? a_col : b_col) + k;
    uint64_t rec[P];
    pack_rec<P>(rec, x, n, nk, c, __ldg(xtb + c));
    store_rec<P>(s, ps, k, rec);
  }
  cp_async_wait_all();
  __syncthreads();

  const int d = tid * K1_V;
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {  // largest i with A[i-1] <= B[d-i]: ties go to A
    const int mid = (lo + hi + 1) >> 1;
    if (!smem_lt<P>(s, ps, na + d - mid, mid - 1)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int ia = lo;
  int ib = d - lo;
  uint64_t ha[P], hb[P];
  if (ia < na) load_rec<P>(ha, s, ps, ia);
  if (ib < nb) load_rec<P>(hb, s, ps, na + ib);
#pragma unroll
  for (int v = 0; v < K1_V; ++v) {
    const bool take_a = ib >= nb || (ia < na && !rec_lt<P>(hb, ha));
    if (take_a) {
      src[sk16(d + v)] = (uint16_t)ia;
      if (++ia < na) load_rec<P>(ha, s, ps, ia);
    } else {
      src[sk16(d + v)] = (uint16_t)(na + ib);
      if (++ib < nb) load_rec<P>(hb, s, ps, na + ib);
    }
  }
  __syncthreads();

  int from[K1_V];
#pragma unroll
  for (int j = 0; j < K1_V; ++j) from[j] = src[sk16(tid + j * nt)];
  for (int row = 0; row < rows; ++row) {
    uint32_t* o = out + (size_t)row * n + out0;
    if (row < nk || row == tb_row) {
      const int w = row < nk ? row : nk;
      const uint64_t* plane = s + (w >> 1) * ps;
      const int sh = half_shift(w);
#pragma unroll
      for (int j = 0; j < K1_V; ++j)
        o[tid + j * nt] = (uint32_t)(plane[sk64(from[j])] >> sh);
    } else {
      const uint32_t* pr = pay + (size_t)(row < tb_row ? row - nk
                                                       : row - nk - 1) * W;
#pragma unroll
      for (int j = 0; j < K1_V; ++j) o[tid + j * nt] = pr[from[j]];
    }
  }
}

template <int P, int R, int NK, int TB> struct MergePassLaunch {
  static int run(const uint32_t* x, uint32_t* out, const uint32_t* splits,
                 size_t n, int rows, int nk, int tb_row, int width,
                 size_t run_len, cudaStream_t stream) {
    const size_t smem = merge_pass_smem(rows, nk, width);
    const int err = set_smem((const void*)merge_pass_kernel<P, R, NK, TB>,
                             smem);
    if (err) return err;
    merge_pass_kernel<P, R, NK, TB>
        <<<(unsigned)(n / width), width / K1_V, smem, stream>>>(
            x, out, splits, n, rows, nk, tb_row, width, run_len);
    return (int)cudaGetLastError();
  }
};

}  // namespace
