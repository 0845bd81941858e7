// K2 (tile sort) and K1 (merge pass) of the lanes-layout sort cascade, for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces:
//   K2  uda_tpu/ops/pallas_sort.py::_tile_sort_kernel   (launcher _tile_sort)
//   K1  uda_tpu/ops/pallas_sort.py::_merge_pass_kernel  (launcher _merge_pass,
//       window table _pass_splits, which each block now computes for itself)
//
// Layout: uint32[rows, n], row-major. Row r holds word r of every record;
// record i is column i. Rows [0, nk) are the key words, row tb_row is the
// stability tie-break (the global arrival index, written by K2), every other
// row is payload. All offsets are size_t: a 32-row call at n = 2^27 holds
// 2^32 words, past any int index.
//
// Order: (key words..., tie-break), each word compared as UNSIGNED 32-bit.
// The tie-break makes every record distinct, so both kernels reproduce the
// stable order exactly and have one correct output.
//
// What bounds them: bytes. Each launch reads the whole [rows, n] array and
// writes it once; the compare work is a few integer operations per byte.
// Design against that: every run is kept ascending between passes (the TPU
// kernels alternate tile directions and mask windows with +inf only to suit
// their bitonic networks; no such device is needed here), key words are
// sorted or merged in shared memory, and every other row moves ONCE per
// launch, by the sorted source index, with coalesced writes. So the 32-row
// `two_phase=True` and `False` cascades are the same kernel on this card.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// s[w * stride + a] < s[w * stride + b] lexicographically over nw words.
__device__ __forceinline__ bool smem_lt(const uint32_t* s, int stride, int a,
                                        const uint32_t* t, int b, int nw) {
  for (int w = 0; w < nw; ++w) {
    const uint32_t u = s[w * stride + a];
    const uint32_t v = t[w * stride + b];
    if (u != v) return u < v;
  }
  return false;
}

// Record a < record b in global memory, by (key rows, tie-break row).
__device__ __forceinline__ bool global_lt(const uint32_t* x, size_t n, int nk,
                                          int tb_row, size_t a, size_t b) {
  for (int w = 0; w < nk; ++w) {
    const uint32_t u = x[(size_t)w * n + a];
    const uint32_t v = x[(size_t)w * n + b];
    if (u != v) return u < v;
  }
  return x[(size_t)tb_row * n + a] < x[(size_t)tb_row * n + b];
}

// K2: one block per tile of `tile` records. Shared memory holds the nk key
// words and the local arrival index of every record of the tile
// ((nk + 1) * tile words); a bitonic network sorts them ascending; then every
// row of the tile is written once in sorted order.
__global__ void tile_sort_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, size_t n,
                                 int rows, int nk, int tb_row, int tile) {
  extern __shared__ uint32_t sm[];
  const int nw = nk + 1;
  uint32_t* pos = sm + (size_t)nk * tile;  // local arrival index
  const size_t base = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    for (int w = 0; w < nk; ++w) sm[w * tile + i] = x[(size_t)w * n + base + i];
    pos[i] = (uint32_t)i;
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const int l = i + j;
        const bool asc = (i & k) == 0;  // k == tile: every block ascends
        if (smem_lt(sm, tile, l, sm, i, nw) == asc) {
          for (int w = 0; w < nw; ++w) {
            const uint32_t t = sm[w * tile + i];
            sm[w * tile + i] = sm[w * tile + l];
            sm[w * tile + l] = t;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const uint32_t src = pos[i];
    for (int r = 0; r < rows; ++r) {
      uint32_t v;
      if (r < nk) {
        v = sm[r * tile + i];
      } else if (r == tb_row) {
        v = (uint32_t)(base + src);
      } else {
        v = x[(size_t)r * n + base + src];
      }
      out[(size_t)r * n + base + i] = v;
    }
  }
}

// K1: one block per output tile of one pass, which merges adjacent ascending
// runs of length run_len into ascending runs of 2 * run_len.
//
// 1. Thread 0 finds the tile's merge-path split by binary search over the two
//    input runs in global memory: i0 = the number of A records among the
//    first d merged records of the pair (ties go to A; with distinct
//    (key, arrival) pairs there are none).
// 2. The block loads A[i0, i0 + tile) and B[j0, j0 + tile), clipped at the
//    run ends, keys and tie-break only, into shared memory.
// 3. Every window record finds its rank in the output tile as its own
//    position plus the number of records of the other window below it
//    (binary search in shared memory); ranks below `tile` record their source
//    column.
// 4. Every row of the tile is written once, gathered by source column.
__global__ void merge_pass_kernel(const uint32_t* __restrict__ x,
                                  uint32_t* __restrict__ out, size_t n,
                                  int rows, int nk, int tb_row, int tile,
                                  size_t run_len) {
  extern __shared__ uint32_t sm[];
  __shared__ size_t s_i0;
  const int nw = nk + 1;
  uint32_t* sa = sm;                        // [nw][tile] A window
  uint32_t* sb = sa + (size_t)nw * tile;    // [nw][tile] B window
  uint32_t* src = sb + (size_t)nw * tile;   // [tile] source column
  const size_t L = run_len;
  const size_t out0 = (size_t)blockIdx.x * tile;
  const size_t a_base = out0 / (2 * L) * (2 * L);
  const size_t b_base = a_base + L;
  const size_t d = out0 - a_base;  // the tile's diagonal within its pair
  if (threadIdx.x == 0) {
    size_t lo = d > L ? d - L : 0;
    size_t hi = d < L ? d : L;
    while (lo < hi) {
      const size_t mid = (lo + hi + 1) / 2;  // candidate: A records taken
      const size_t j = d - mid;              // B records taken (< L)
      if (!global_lt(x, n, nk, tb_row, b_base + j, a_base + mid - 1)) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    s_i0 = lo;
  }
  __syncthreads();
  const size_t i0 = s_i0;
  const size_t j0 = d - i0;
  const int a_len = (int)(L - i0 < (size_t)tile ? L - i0 : (size_t)tile);
  const int b_len = (int)(L - j0 < (size_t)tile ? L - j0 : (size_t)tile);
  for (int w = 0; w < nw; ++w) {
    const size_t row = (size_t)(w < nk ? w : tb_row) * n;
    for (int i = threadIdx.x; i < a_len; i += blockDim.x)
      sa[w * tile + i] = x[row + a_base + i0 + i];
    for (int i = threadIdx.x; i < b_len; i += blockDim.x)
      sb[w * tile + i] = x[row + b_base + j0 + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a_len + b_len; i += blockDim.x) {
    const bool from_a = i < a_len;
    const int p = from_a ? i : i - a_len;
    const uint32_t* self = from_a ? sa : sb;
    const uint32_t* other = from_a ? sb : sa;
    int lo = 0;
    int hi = from_a ? b_len : a_len;
    while (lo < hi) {  // count of `other` records below self[p]
      const int mid = (lo + hi) >> 1;
      if (smem_lt(other, tile, mid, self, p, nw)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int rank = p + lo;
    if (rank < tile)
      src[rank] = (uint32_t)((from_a ? a_base + i0 : b_base + j0) + p);
  }
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const size_t row = (size_t)r * n;
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      out[row + out0 + i] = x[row + src[i]];
  }
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory bytes one block of each kernel asks for.
size_t uda_tile_sort_smem(int nk, int tile) {
  return (size_t)(nk + 1) * tile * sizeof(uint32_t);
}

size_t uda_merge_pass_smem(int nk, int tile) {
  return (size_t)(2 * (nk + 1) + 1) * tile * sizeof(uint32_t);
}

// Every launcher returns cudaGetLastError() after its launch (0 = success).
int uda_tile_sort(const void* x, void* out, size_t n, int rows, int nk,
                  int tb_row, int tile, void* stream) {
  const size_t smem = uda_tile_sort_smem(nk, tile);
  int err = set_smem((const void*)tile_sort_kernel, smem);
  if (err) return err;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  tile_sort_kernel<<<(unsigned)(n / tile), threads, smem,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, rows, nk, tb_row, tile);
  return (int)cudaGetLastError();
}

int uda_merge_pass(const void* x, void* out, size_t n, int rows, int nk,
                   int tb_row, int tile, size_t run_len, void* stream) {
  const size_t smem = uda_merge_pass_smem(nk, tile);
  int err = set_smem((const void*)merge_pass_kernel, smem);
  if (err) return err;
  const int threads = tile < 512 ? tile : 512;
  merge_pass_kernel<<<(unsigned)(n / tile), threads, smem,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, rows, nk, tb_row, tile,
      run_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
