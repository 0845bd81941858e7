// K5 (lane gather) for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces: scripts/probe_gather.py's pl.pallas_call, whose four bodies
// (kern_take, kern_take_along, kern_take_along_i32, kern_onehot_matmul) all
// compute out[:, j] = x[:, perm[j]] on uint32[rows, n] by an int32
// permutation: the in-kernel lane gather that the reference's two-phase
// merge (uda_tpu/ops/pallas_sort.py::_merge_pass_kernel, two_phase=True)
// applies to its payload rows.
//
// What bounds it: bytes. Every output word is written once and every input
// word read once (perm once per row, from L1/L2 after the first row). The
// design: one thread per output word, a block of 256 consecutive columns of
// one row, so the writes and the perm reads are coalesced; the reads of x
// follow the permutation and are as scattered as it is.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void lane_gather_kernel(const uint32_t* __restrict__ x,
                                   const int32_t* __restrict__ perm,
                                   uint32_t* __restrict__ out, size_t n) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t row = (size_t)blockIdx.y * n;
  out[row + j] = __ldg(x + row + (uint32_t)__ldg(perm + j));
}

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Returns cudaGetLastError() after the launch (0 = success).
int uda_lane_gather(const void* x, const void* perm, void* out, int rows,
                    size_t n, void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)rows);
  lane_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const int32_t*)perm, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
