// K5 (lane gather) for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces: scripts/probe_gather.py:62, the pl.pallas_call whose four
// bodies (kern_take :25, kern_take_along :29, kern_take_along_i32 :34,
// kern_onehot_matmul :42) all compute out[:, j] = x[:, perm[j]] on
// uint32[rows, n] by an int32 index: the probe of the in-kernel payload
// gather that the reference's two-phase merge applies to its [32, 2T]
// window (uda_tpu/ops/pallas_sort.py:391-405). Here perm is any int32[n]
// with values in [0, n), repeated indices allowed.
//
// What bounds it: bytes. The least the function moves is x read once, perm
// read once and out written once: (2 * rows * n + n) * 4 bytes.
//
// Why a column-wise gather cannot reach that bound for a random perm: the
// direct design (one thread per output word, lane_gather_kernel below)
// reads 4 useful bytes at a random column of each row, and every such read
// costs the whole 32-byte sector around it, 8x the word. perm is read again
// for every row as well. At [8, 2^27] that is about 43 GB moved for a
// bound of 9.1 GB.
//
// The design: two passes, each moving whole sectors.
// 1. records_kernel transposes x into a scratch xt = uint32[n, rows_p],
//    one record of rows_p = rows rounded up to 4 words per column (16-byte
//    aligned; 8 rows give one 32-byte sector a record). A block takes 256
//    columns and up to 8 record words: it reads its rows as coalesced
//    (16-byte vector where n % 4 == 0) row segments into a shared tile and
//    writes its records as 16-byte stores, consecutive threads on
//    consecutive addresses.
// 2. gather_kernel takes 256 output columns and up to 8 record words: it
//    reads its slice of perm once, fetches each column's record words
//    xt[perm[j]] as 16-byte loads (one sector at rows_p = 8, every byte of
//    it used), stages the tile in shared memory and writes it out as
//    coalesced row segments of out.
// At [8, 2^27] the two passes move about 17.7 GB: 4.3 in and 4.3 out for
// the transpose, 0.5 of perm, 4.3 of records and 4.3 out for the gather.
// The transpose streams at the card's copy rate. The records are still
// random 32-byte sectors, which DRAM serves well below its streaming
// rate, so the pair cannot reach the bound either; a design
// without the transpose would need a random sector per row and column.
//
// The shared tile is [8][256 + 4] words: a warp storing record words
// (word 4q + k of column jj) touches bank 16q + 4k + jj (mod 32), all
// distinct for records of one or two 16-byte quads.
//
// Small shapes: up to 1 MiB of x (rows * n * 4 bytes; SMALL_BYTES in
// ops/lane_gather.py) the wrapper launches the direct kernel: x sits in L2,
// so its wasted sectors cost little, and one launch beats two. The rule
// reads the shape alone, never the data.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;          // columns a block takes
constexpr int kThreads = 256;
constexpr int kChunk = 8;           // record words a block takes
constexpr int kPitch = kTile + 4;   // shared tile row pitch, in words

// The direct design: one thread per output word.
__global__ void lane_gather_kernel(const uint32_t* __restrict__ x,
                                   const int32_t* __restrict__ perm,
                                   uint32_t* __restrict__ out, size_t n) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t row = (size_t)blockIdx.y * n;
  out[row + j] = __ldg(x + row + (uint32_t)__ldg(perm + j));
}

// Rows [0, 4Q) of the tile from rows [r0, r0 + 4Q) of a [rows, n] matrix
// at columns [c0, c0 + tc); rows past `live` and columns past tc read 0.
template <int Q, bool VEC>
__device__ __forceinline__ void load_rows(uint32_t* s,
                                          const uint32_t* __restrict__ x,
                                          size_t n, int r0, int live,
                                          size_t c0, int tc) {
  if (VEC) {
    constexpr int kQuads = kTile / 4;
#pragma unroll
    for (int i = 0; i < Q * kTile / kThreads; ++i) {
      const int L = threadIdx.x + i * kThreads;
      const int r = L / kQuads;
      const int p = L % kQuads;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < live && 4 * p < tc)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * n +
                                                 c0) + p);
      *reinterpret_cast<uint4*>(s + r * kPitch + 4 * p) = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * Q * kTile / kThreads; ++i) {
      const int L = threadIdx.x + i * kThreads;
      const int r = L / kTile;
      const int c = L % kTile;
      s[r * kPitch + c] = (r < live && c < tc)
                              ? __ldg(x + (size_t)(r0 + r) * n + c0 + c)
                              : 0u;
    }
  }
}

// Rows [0, live) of the tile to rows [r0, r0 + live) of a [rows, n] matrix
// at columns [c0, c0 + tc).
template <bool VEC>
__device__ __forceinline__ void store_rows(const uint32_t* s,
                                           uint32_t* __restrict__ out,
                                           size_t n, int r0, int live,
                                           size_t c0, int tc) {
  if (VEC) {
    constexpr int kQuads = kTile / 4;
    for (int L = threadIdx.x; L < live * kQuads; L += kThreads) {
      const int r = L / kQuads;
      const int p = L % kQuads;
      if (4 * p < tc)
        reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * n + c0)[p] =
            *reinterpret_cast<const uint4*>(s + r * kPitch + 4 * p);
    }
  } else {
    for (int L = threadIdx.x; L < live * kTile; L += kThreads) {
      const int r = L / kTile;
      const int c = L % kTile;
      if (c < tc) out[(size_t)(r0 + r) * n + c0 + c] = s[r * kPitch + c];
    }
  }
}

// Record word quad q of tile column jj, from the tile / into the tile.
__device__ __forceinline__ uint4 tile_quad(const uint32_t* s, int q, int jj) {
  const uint32_t* t = s + 4 * q * kPitch + jj;
  return make_uint4(t[0], t[kPitch], t[2 * kPitch], t[3 * kPitch]);
}

__device__ __forceinline__ void set_tile_quad(uint32_t* s, int q, int jj,
                                              uint4 v) {
  uint32_t* t = s + 4 * q * kPitch + jj;
  t[0] = v.x;
  t[kPitch] = v.y;
  t[2 * kPitch] = v.z;
  t[3 * kPitch] = v.w;
}

// Pass 1: xt[c, r0 + w] = x[r0 + w, c] for the block's 4Q record words.
template <int Q, bool VEC>
__device__ __forceinline__ void records_body(uint32_t* s,
                                             const uint32_t* __restrict__ x,
                                             uint32_t* __restrict__ xt,
                                             int rows, int rows_p, size_t n) {
  const int r0 = blockIdx.y * kChunk;
  const size_t c0 = (size_t)blockIdx.x * kTile;
  const int tc = n - c0 < (size_t)kTile ? (int)(n - c0) : kTile;
  load_rows<Q, VEC>(s, x, n, r0, min(4 * Q, rows - r0), c0, tc);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < Q * kTile / kThreads; ++i) {
    const int L = threadIdx.x + i * kThreads;
    const int jj = L / Q;
    const int q = L % Q;
    if (jj < tc)
      reinterpret_cast<uint4*>(xt + (c0 + jj) * rows_p + r0)[q] =
          tile_quad(s, q, jj);
  }
}

// Pass 2: out[r0 + w, j] = xt[perm[j], r0 + w] for the block's 4Q rows.
template <int Q, bool VEC>
__device__ __forceinline__ void gather_body(uint32_t* s,
                                            const uint32_t* __restrict__ xt,
                                            const int32_t* __restrict__ perm,
                                            uint32_t* __restrict__ out,
                                            int rows, int rows_p, size_t n) {
  constexpr int kItems = Q * kTile / kThreads;
  const int r0 = blockIdx.y * kChunk;
  const size_t j0 = (size_t)blockIdx.x * kTile;
  const int tc = n - j0 < (size_t)kTile ? (int)(n - j0) : kTile;
  uint4 v[kItems];
  // every load first, so each thread has all its sectors in flight at once
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int L = threadIdx.x + i * kThreads;
    const int jj = L / Q;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (jj < tc) {
      const size_t p = (uint32_t)__ldg(perm + j0 + jj);
      v[i] = __ldg(reinterpret_cast<const uint4*>(xt + p * rows_p + r0) +
                   L % Q);
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int L = threadIdx.x + i * kThreads;
    set_tile_quad(s, L % Q, L / Q, v[i]);
  }
  __syncthreads();
  store_rows<VEC>(s, out, n, r0, min(4 * Q, rows - r0), j0, tc);
}

// The last chunk of a record is one quad when rows_p % 8 == 4.
__device__ __forceinline__ int chunk_quads(int rows_p) {
  return min(2, (rows_p - (int)blockIdx.y * kChunk) / 4);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    records_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ xt,
                   int rows, int rows_p, size_t n) {
  __shared__ __align__(16) uint32_t s[kChunk * kPitch];
  if (chunk_quads(rows_p) == 2)
    records_body<2, VEC>(s, x, xt, rows, rows_p, n);
  else
    records_body<1, VEC>(s, x, xt, rows, rows_p, n);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const uint32_t* __restrict__ xt,
                  const int32_t* __restrict__ perm, uint32_t* __restrict__ out,
                  int rows, int rows_p, size_t n) {
  __shared__ __align__(16) uint32_t s[kChunk * kPitch];
  if (chunk_quads(rows_p) == 2)
    gather_body<2, VEC>(s, xt, perm, out, rows, rows_p, n);
  else
    gather_body<1, VEC>(s, xt, perm, out, rows, rows_p, n);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* uda_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The direct design. Returns cudaGetLastError() after the launch
// (0 = success).
int uda_lane_gather(const void* x, const void* perm, void* out, int rows,
                    size_t n, void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)rows);
  lane_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const int32_t*)perm, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// The two-pass design through the scratch xt (uint32[n, rows_p]); the
// caller sizes xt and gives its record width rows_p, a multiple of 4 no
// less than rows (ops/lane_gather.record_words). Returns cudaGetLastError()
// after the first failed launch or the last.
int uda_lane_gather_records(const void* x, const void* perm, void* xt,
                            void* out, int rows, int rows_p, size_t n,
                            void* stream) {
  const dim3 grid((unsigned)((n + kTile - 1) / kTile),
                  (unsigned)((rows_p + kChunk - 1) / kChunk));
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 4 == 0;
  if (vec && aligned16(x))
    records_kernel<true><<<grid, kThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)xt, rows, rows_p, n);
  else
    records_kernel<false><<<grid, kThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)xt, rows, rows_p, n);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (vec && aligned16(out))
    gather_kernel<true><<<grid, kThreads, 0, st>>>(
        (const uint32_t*)xt, (const int32_t*)perm, (uint32_t*)out, rows,
        rows_p, n);
  else
    gather_kernel<false><<<grid, kThreads, 0, st>>>(
        (const uint32_t*)xt, (const int32_t*)perm, (uint32_t*)out, rows,
        rows_p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
