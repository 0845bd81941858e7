// K3 (tile sort) and K4 (merge pass) of the slim keys cascade, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces:
//   K3  uda_tpu/ops/pallas_fold.py::_tile_sort_kernel_folded
//       (launcher _tile_sort_folded)
//   K4  uda_tpu/ops/pallas_fold.py::_merge_pass_kernel_folded
//       (launcher _merge_pass_folded, window table pallas_sort._pass_splits)
//
// Layout: the slim uint32[4, n] array, rows [k0, k1, k2, tb]: NK <= 3 key
// rows (rows NK..2 are payload), row 3 the tie-break (global arrival index,
// written by K3). The TPU kernels fold two element halves into 8 rows to
// halve their vector work; that is a TPU device, not a contract. Here the
// specialisation is the 16-byte record: each block gathers the four rows of
// a record into one uint4 in shared memory, compares NK key words (unrolled,
// unsigned) and then the tie-break, moves records as 16-byte units, and
// writes the four rows back from shared memory, so no row is read twice.
//
// What bounds them: bytes (each launch reads and writes 16 bytes a record).
// Runs stay ascending between passes, as in lanes_sort.cu.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int NK>
__device__ __forceinline__ bool rec_lt(const uint4& a, const uint4& b) {
  if (a.x != b.x) return a.x < b.x;
  if (NK > 1 && a.y != b.y) return a.y < b.y;
  if (NK > 2 && a.z != b.z) return a.z < b.z;
  return a.w < b.w;
}

__device__ __forceinline__ uint4 load_rec(const uint32_t* x, size_t n,
                                          size_t i) {
  return make_uint4(x[i], x[n + i], x[2 * n + i], x[3 * n + i]);
}

__device__ __forceinline__ void store_rec(uint32_t* out, size_t n, size_t i,
                                          const uint4& r) {
  out[i] = r.x;
  out[n + i] = r.y;
  out[2 * n + i] = r.z;
  out[3 * n + i] = r.w;
}

// K3: one block per tile; a bitonic network over `tile` uint4 records in
// shared memory, ascending.
template <int NK>
__global__ void tile_sort_folded_kernel(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out, size_t n,
                                        int tile) {
  extern __shared__ uint4 rec[];
  const size_t base = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    uint4 r = load_rec(x, n, base + i);
    r.w = (uint32_t)(base + i);  // arrival index
    rec[i] = r;
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));
        const int l = i + j;
        const bool asc = (i & k) == 0;
        const uint4 ri = rec[i];
        const uint4 rl = rec[l];
        if (rec_lt<NK>(rl, ri) == asc) {
          rec[i] = rl;
          rec[l] = ri;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    store_rec(out, n, base + i, rec[i]);
}

// K4: one block per output tile of one pass; the merge-path split by binary
// search in global memory, both windows as uint4 records in shared memory,
// every record's output rank by binary search in the other window, and the
// output tile written from shared memory.
template <int NK>
__global__ void merge_pass_folded_kernel(const uint32_t* __restrict__ x,
                                         uint32_t* __restrict__ out, size_t n,
                                         int tile, size_t run_len) {
  extern __shared__ uint4 sm4[];
  __shared__ size_t s_i0;
  uint4* sa = sm4;
  uint4* sb = sa + tile;
  uint4* so = sb + tile;
  const size_t L = run_len;
  const size_t out0 = (size_t)blockIdx.x * tile;
  const size_t a_base = out0 / (2 * L) * (2 * L);
  const size_t b_base = a_base + L;
  const size_t d = out0 - a_base;
  if (threadIdx.x == 0) {
    size_t lo = d > L ? d - L : 0;
    size_t hi = d < L ? d : L;
    while (lo < hi) {
      const size_t mid = (lo + hi + 1) / 2;
      const size_t j = d - mid;
      if (!rec_lt<NK>(load_rec(x, n, b_base + j),
                      load_rec(x, n, a_base + mid - 1))) {
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
  for (int i = threadIdx.x; i < a_len; i += blockDim.x)
    sa[i] = load_rec(x, n, a_base + i0 + i);
  for (int i = threadIdx.x; i < b_len; i += blockDim.x)
    sb[i] = load_rec(x, n, b_base + j0 + i);
  __syncthreads();
  for (int i = threadIdx.x; i < a_len + b_len; i += blockDim.x) {
    const bool from_a = i < a_len;
    const int p = from_a ? i : i - a_len;
    const uint4 self = from_a ? sa[p] : sb[p];
    const uint4* other = from_a ? sb : sa;
    int lo = 0;
    int hi = from_a ? b_len : a_len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rec_lt<NK>(other[mid], self)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int rank = p + lo;
    if (rank < tile) so[rank] = self;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    store_rec(out, n, out0 + i, so[i]);
}

template <int NK>
int launch_tile_sort(const void* x, void* out, size_t n, int tile,
                     cudaStream_t stream) {
  const size_t smem = (size_t)tile * sizeof(uint4);
  int err = (int)cudaFuncSetAttribute(
      (const void*)tile_sort_folded_kernel<NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  tile_sort_folded_kernel<NK><<<(unsigned)(n / tile), threads, smem, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, tile);
  return (int)cudaGetLastError();
}

template <int NK>
int launch_merge_pass(const void* x, void* out, size_t n, int tile,
                      size_t run_len, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)tile * sizeof(uint4);
  int err = (int)cudaFuncSetAttribute(
      (const void*)merge_pass_folded_kernel<NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int threads = tile < 512 ? tile : 512;
  merge_pass_folded_kernel<NK><<<(unsigned)(n / tile), threads, smem,
                                 stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, tile, run_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

size_t uda_tile_sort_folded_smem(int tile) {
  return (size_t)tile * sizeof(uint4);
}

size_t uda_merge_pass_folded_smem(int tile) {
  return 3 * (size_t)tile * sizeof(uint4);
}

// nk in 1..3 (checked by the Python wrapper); returns cudaGetLastError().
int uda_tile_sort_folded(const void* x, void* out, size_t n, int nk, int tile,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nk == 1) return launch_tile_sort<1>(x, out, n, tile, s);
  if (nk == 2) return launch_tile_sort<2>(x, out, n, tile, s);
  return launch_tile_sort<3>(x, out, n, tile, s);
}

int uda_merge_pass_folded(const void* x, void* out, size_t n, int nk,
                          int tile, size_t run_len, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nk == 1) return launch_merge_pass<1>(x, out, n, tile, run_len, s);
  if (nk == 2) return launch_merge_pass<2>(x, out, n, tile, run_len, s);
  return launch_merge_pass<3>(x, out, n, tile, run_len, s);
}

}  // extern "C"
