// K3 (tile sort) and K4 (merge pass) of the slim keys cascade, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces:
//   K3  uda_tpu/ops/pallas_fold.py::_tile_sort_kernel_folded
//       (launcher _tile_sort_folded)
//   K4  uda_tpu/ops/pallas_fold.py::_merge_pass_kernel_folded
//       (launcher _merge_pass_folded, window table pallas_sort._pass_splits,
//       which lanes_sort.cu's merge_partition_kernel computes on the card)
//
// Layout: the slim uint32[4, n] array, rows [k0, k1, k2, tb]: NK <= 3 key
// rows (rows NK..2 are payload), row 3 the tie-break (global arrival index,
// written by K3). The TPU kernels fold two element halves into 8 rows to
// halve their vector work; that is a TPU device, not a contract.
//
// Both kernels are the device code of K2 and K1 (lanes_common.cuh),
// instantiated for this layout with the rows, key count and tie-break row
// fixed at compile time: 4 rows, tie-break row 3, NK = 1 (one plane,
// k0|tb, two payload rows), 2 (two planes, one payload row) or 3 (two
// planes, no payload).
//
// What bounds them: bytes, 16 a record read and 16 written per launch,
// half of the 8-row keys8 matrix's. What keeps them off that bound is
// latency: a sorting network's barrier per stage, and a block that waits
// for its split or loads more of a run than it merges. The designs below
// avoid both.
//
// K3 (tile_sort_kernel): a block merge sort with the data in registers (V
//   records sorted per thread with no barrier, then log2(tile / V) merge-
//   path rounds in shared memory); every row is written once. Its rounds,
//   not its bytes, set its pace. One block takes tiles up to
//   uda_tile_sort_folded_max_tile (16384 at 1 key word, 8192 at 2-3); the
//   wrapper sorts a wider tile as such sub-tiles merged by K4.
// K4 (merge_pass_kernel after the partition): every block's split is found
//   in parallel beforehand, with ties to A, so no block waits on a search
//   that grows with the run length. Each block loads
//   exactly its width of records, every word once and coalesced, merges 8
//   outputs a thread from register heads and writes every row once. Its
//   width comes from the slim layout's own shared-memory budget
//   (uda_merge_pass_folded_width), not from the tile, so every tile the
//   CPU takes launches.

#include "lanes_common.cuh"

namespace {

constexpr int SLIM_ROWS = 4;
constexpr int SLIM_TB = 3;
// 2048 records a block at every key count (39-47 KB); registers (62-64 a
// thread) then allow 4 blocks of 256 threads per SM. 4096 records (2
// blocks per SM) measured no faster, and capping the registers for a
// fifth block was slower.
constexpr size_t K4_SMEM_BUDGET = 48 * 1024;

// F<planes_of(nk), 4, nk, 3>::run(a...) for nk in 1..3, or `none`.
template <template <int, int, int, int> class F, typename R, typename... A>
R dispatch_slim(int nk, R none, A... a) {
  switch (nk) {
    case 1: return F<planes_of(1), SLIM_ROWS, 1, SLIM_TB>::run(a...);
    case 2: return F<planes_of(2), SLIM_ROWS, 2, SLIM_TB>::run(a...);
    case 3: return F<planes_of(3), SLIM_ROWS, 3, SLIM_TB>::run(a...);
    default: return none;
  }
}

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The widest power-of-two tile one K3 block takes for nk key words with
// smem_limit bytes of shared memory; 0 for a key count K3 does not take.
int uda_tile_sort_folded_max_tile(int nk, size_t smem_limit) {
  return dispatch_slim<TileSortMaxTile>(nk, 0, nk, smem_limit);
}

// K4's block width for one pass: the largest power of two up to 4096 that
// divides n and 2 * run_len and whose shared memory fits K4's budget; 0
// for a key count K4 does not take.
int uda_merge_pass_folded_width(int nk, size_t n, size_t run_len) {
  if (nk < 1 || nk > 3) return 0;
  return merge_width(SLIM_ROWS, nk, n, run_len, K4_SMEM_BUDGET);
}

// Every launcher returns cudaGetLastError() after its launch (0 = success).
int uda_tile_sort_folded(const void* x, void* out, size_t n, int nk,
                         int tile, void* stream) {
  return dispatch_slim<TileSortLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)out, n,
      SLIM_ROWS, nk, SLIM_TB, tile, (cudaStream_t)stream);
}

// `splits` from lanes_sort.cu's uda_merge_partition at the same width.
int uda_merge_pass_folded(const void* x, void* out, const void* splits,
                          size_t n, int nk, int width, size_t run_len,
                          void* stream) {
  return dispatch_slim<MergePassLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)out,
      (const uint32_t*)splits, n, SLIM_ROWS, nk, SLIM_TB, width, run_len,
      (cudaStream_t)stream);
}

}  // extern "C"
