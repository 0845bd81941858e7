// K2 (tile sort) and K1 (merge pass, with its partition kernel) of the
// lanes-layout sort cascade, for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces:
//   K2  uda_tpu/ops/pallas_sort.py::_tile_sort_kernel   (launcher _tile_sort)
//   K1  uda_tpu/ops/pallas_sort.py::_merge_pass_kernel  (launcher _merge_pass)
//       and its window table _pass_splits, which merge_partition_kernel
//       computes on the card, one thread per block boundary searching on a
//       power-of-two grid (lanes_common.cuh)
//
// The device code (layout, order, packed planes, the kernels themselves) is
// in lanes_common.cuh, shared with K3/K4; this file instantiates it for
// every row layout, with rows, key count and tie-break row read at run time.
//
// What bounds them: bytes. A launch must read every row once and write it
// once; the compares are a few integer operations per byte. The TPU
// kernels' devices (alternating tile directions, +inf window masks, cyclic
// lane rolls) suit a bitonic network and are not carried over: every run
// stays ascending between passes.
//
// K2 (tile_sort_kernel): its bytes are one read and one write of every
//   row, but a sorting network in shared memory makes it compute- and
//   barrier-bound (a bitonic network needs 55 barriered stages at tile
//   1024). So it is a block merge sort with the data in registers (the
//   pattern of CUB's BlockMergeSort, written here): each thread sorts V
//   records in registers with no barrier, then log2(tile / V) merge-path
//   rounds in shared memory, two barriers each; every row is written once,
//   coalesced. The rounds, not the bytes, still set its pace. One block
//   takes tiles up to uda_tile_sort_max_tile (its threads' registers and
//   its shared memory); the wrapper sorts a wider tile as such sub-tiles
//   merged by K1, which orders by the same (keys, arrival index).
// K1 (merge_pass_kernel with merge_partition_kernel): bound by bytes, and
//   by latency where a block waits for its split or its window. The
//   partition kernel finds every block's merge-path split in parallel, so
//   a block knows both of its ends before it starts; it then loads exactly
//   its output width of records from the two runs, every row once (payload
//   rows by cp.async, coalesced), merges in shared memory (each thread one
//   binary search and V records merged serially from register heads) and
//   writes every row once, coalesced. The block width comes from the
//   shared-memory budget (3 blocks per SM), never spans two run pairs, and
//   does not change the output.

#include "lanes_common.cuh"

namespace {

constexpr size_t K1_SMEM_BUDGET = 74 * 1024;  // 3 blocks per SM

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory bytes one block of K1 asks for at `width` records.
size_t uda_merge_pass_smem(int rows, int nk, int width) {
  return merge_pass_smem(rows, nk, width);
}

// The widest power-of-two tile one K2 block takes for nk key words with
// smem_limit bytes of shared memory; 0 for a key count K2 does not take.
int uda_tile_sort_max_tile(int nk, size_t smem_limit) {
  return dispatch_planes<TileSortMaxTile>(nk, 0, nk, smem_limit);
}

// K1's block width for one pass: the largest power of two up to
// K1_MAX_WIDTH that divides n and 2 * run_len and whose shared memory fits
// the budget (at least K1_V); 0 for a key count K1 does not take.
int uda_merge_pass_width(int rows, int nk, size_t n, size_t run_len) {
  return merge_width(rows, nk, n, run_len, K1_SMEM_BUDGET);
}

// Every launcher returns cudaGetLastError() after its launch (0 = success).
int uda_tile_sort(const void* x, void* out, size_t n, int rows, int nk,
                  int tb_row, int tile, void* stream) {
  return dispatch_planes<TileSortLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)out, n,
      rows, nk, tb_row, tile, (cudaStream_t)stream);
}

int uda_merge_partition(const void* x, void* splits, size_t n, int nk,
                        int tb_row, int width, size_t run_len,
                        void* stream) {
  const size_t blocks = n / width;
  const int threads = 256;
  merge_partition_kernel<<<(unsigned)((blocks + threads - 1) / threads),
                           threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)splits, n, nk, tb_row, width, run_len,
      blocks);
  return (int)cudaGetLastError();
}

int uda_merge_pass(const void* x, void* out, const void* splits, size_t n,
                   int rows, int nk, int tb_row, int width, size_t run_len,
                   void* stream) {
  return dispatch_planes<MergePassLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)out,
      (const uint32_t*)splits, n, rows, nk, tb_row, width, run_len,
      (cudaStream_t)stream);
}

}  // extern "C"
