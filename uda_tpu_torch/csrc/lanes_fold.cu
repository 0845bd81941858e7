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
//   tile_sort_records_kernel is the same body reading the key words from
//   row-major records in place (TeraSort's uint32[n, 26]), so no [4, m]
//   key matrix is built for it.
// K4 (merge_pass_kernel after the partition): every block's split is found
//   in parallel beforehand, with ties to A, so no block waits on a search
//   that grows with the run length. Each block loads
//   exactly its width of records, every word once and coalesced, merges 8
//   outputs a thread from register heads and writes every row once. Its
//   width comes from the slim layout's own shared-memory budget
//   (uda_merge_pass_folded_width), not from the tile, so every tile the
//   CPU takes launches.
// K4, four-way (merge4_pass_kernel after merge4_partition_kernel): a pass
//   merges groups of four adjacent runs A, B, C, D into one, so a cascade
//   takes half the passes at the same 32 B a column a pass; the cascade
//   ends in a two-way pass where two runs are left. Its output is the
//   two-way passes' (ties to the earlier run), byte for byte. The
//   partition finds each block boundary's four splits at once by a
//   multiway selection on the power-of-two grid (below), one thread a
//   boundary; a block loads exactly its four windows, merges A with B and
//   C with D, then the two results, in shared memory, and writes every row
//   once. The two-way kernels above and in lanes_common.cuh are the ones K1
//   and K4's last pass run, unchanged.

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

// ------------------------------------------------ four-way merge pass (K4)

constexpr int WAYS = 4;             // runs a group
constexpr int K4_V = 8;             // four-way outputs a thread (16: slower)
constexpr int K4_PARTITION_THREADS = 128;

// The four runs of the group that starts at column g0 of a pass over n
// columns with runs of L, as pair_runs takes a pair's: L each where the
// group lies wholly inside n; a cascade on a whole number of blocks ends in
// a group whose last runs are short or empty (a group of one run copies
// it).
__device__ __forceinline__ void group_runs(size_t n, size_t L, size_t g0,
                                           size_t (&len)[WAYS]) {
#pragma unroll
  for (int r = 0; r < WAYS; ++r) {
    const size_t start = g0 + r * L;
    const size_t left = n > start ? n - start : 0;
    len[r] = left < L ? left : L;
  }
}

// A record the partition compares, by its column and first key word, or
// none (col == NONE).
struct Probe {
  size_t col;
  uint32_t w0;
};
constexpr size_t NONE = ~(size_t)0;

__device__ __forceinline__ Probe probe_at(const uint32_t* __restrict__ x,
                                          size_t col) {
  return {col, __ldg(x + col)};
}

// a before b in a four-way pass's order: (key words, tie-break), then the
// column, so equal records keep their runs' order (A before B before C
// before D) and each run's own. The first key words decide almost every
// compare; on equal ones the other words are loaded at once.
template <int NK, int TB>
__device__ __forceinline__ bool probe_before(const uint32_t* __restrict__ x,
                                             size_t n, const Probe& a,
                                             const Probe& b) {
  if (a.w0 != b.w0) return a.w0 < b.w0;
  uint32_t u[NK], v[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {  // words 1..NK-1, then the tie-break
    const size_t row = (size_t)(k + 1 < NK ? k + 1 : TB) * n;
    u[k] = __ldg(x + row + a.col);
    v[k] = __ldg(x + row + b.col);
  }
#pragma unroll
  for (int k = 0; k < NK; ++k)
    if (u[k] != v[k]) return u[k] < v[k];
  return a.col < b.col;
}

// The four-way partition: for every block boundary (output column
// b * width), the numbers of A, B, C and D records among the group's first d
// merged records (d = its diagonal), ties to the earlier run; they sum to d.
//
// Design: a multiway selection on the power-of-two grid (the refinement of
// Varman et al.'s multisequence selection that GNU libstdc++'s parallel
// mode runs as multiseq_partition). At grid g, a run's samples are its
// records g - 1, 2g - 1, ... (the last of each whole g-chunk); cnt[r] is
// how many of run r's samples lie in the floor(d / g) smallest samples of
// the group. From g to g / 2, run r's samples are its old ones and one new
// sample between each two: the new ones below x*, the largest sample
// taken at g, join (one compare each: only the one after a run's last
// taken sample is in question), then at most four of the largest taken
// leave, or one of the smallest left joins, until floor(d / (g / 2)) are
// taken. At g = 1 the samples are the records, and cnt is the split.
//
// What bounds it: dependent reads, as the two-way partition's (one thread a
// boundary, its coarse reads shared in the caches). A level reads the four
// new samples and the sample before x*, which the first leaver needs, all
// at once; a second leaver from one run, or a joiner, reads one more. So
// about one round trip a level, log2(L) + 1 levels.
template <int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K4_PARTITION_THREADS)
    merge4_partition_kernel(const uint32_t* __restrict__ x,
                            uint32_t* __restrict__ splits, size_t n,
                            int width, size_t run_len, size_t blocks) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const size_t L = run_len;
  const size_t out0 = b * width;
  const size_t g0 = out0 / (WAYS * L) * (WAYS * L);
  const size_t d = out0 - g0;
  size_t len[WAYS], cnt[WAYS];
  Probe last[WAYS], next[WAYS];  // per run: the last sample taken, the next
  group_runs(n, L, g0, len);
#pragma unroll
  for (int r = 0; r < WAYS; ++r) {
    cnt[r] = 0;
    last[r] = next[r] = Probe{NONE, 0};
  }
  // at grid 2L no run has a sample: start there, with none taken
  for (size_t g = L; d; g >>= 1) {
    int top = -1;  // the run of x*
    Probe xs{NONE, 0};
#pragma unroll
    for (int r = 0; r < WAYS; ++r)
      if (last[r].col != NONE &&
          (top < 0 || probe_before<NK, TB>(x, n, xs, last[r]))) {
        top = r;
        xs = last[r];
      }
    Probe odd[WAYS];
    Probe pre{NONE, 0};
    size_t pre_idx = 0;
#pragma unroll
    for (int r = 0; r < WAYS; ++r) {
      const size_t base = g0 + r * L;
      const size_t i = 2 * cnt[r] + 1;  // the new sample after the last
      odd[r] = i * g <= len[r] ? probe_at(x, base + i * g - 1)
                               : Probe{NONE, 0};
      if (r == top) {  // cnt[top] >= 1: x* is its sample cnt[top]
        pre_idx = 2 * cnt[r] - 1;
        pre = probe_at(x, base + pre_idx * g - 1);
      }
    }
    size_t taken = 0;
#pragma unroll
    for (int r = 0; r < WAYS; ++r) {
      cnt[r] *= 2;
      if (top >= 0 && odd[r].col != NONE &&
          probe_before<NK, TB>(x, n, odd[r], xs)) {
        ++cnt[r];
        last[r] = odd[r];  // next stays: the old next, sample 2 cnt + 2
      } else {
        next[r] = odd[r];  // none where the run has no such sample
      }
      taken += cnt[r];
    }
    const size_t want = d / g;
    while (taken > want) {  // the largest taken leaves
      int hi = -1;
      Probe hv{NONE, 0};
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (last[r].col != NONE &&
            (hi < 0 || probe_before<NK, TB>(x, n, hv, last[r]))) {
          hi = r;
          hv = last[r];
        }
      if (hi < 0) break;  // only on runs that do not ascend
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (r == hi) {
          next[r] = last[r];
          --cnt[r];
          if (!cnt[r])
            last[r] = Probe{NONE, 0};
          else if (r == top && cnt[r] == pre_idx)
            last[r] = pre;
          else
            last[r] = probe_at(x, g0 + r * L + cnt[r] * g - 1);
        }
      --taken;
    }
    while (taken < want) {  // the smallest left joins
      int lo = -1;
      Probe lv{NONE, 0};
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (next[r].col != NONE &&
            (lo < 0 || probe_before<NK, TB>(x, n, next[r], lv))) {
          lo = r;
          lv = next[r];
        }
      if (lo < 0) break;  // only on runs that do not ascend
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (r == lo) {
          last[r] = next[r];
          ++cnt[r];
          const size_t i = cnt[r] + 1;
          next[r] = i * g <= len[r] ? probe_at(x, g0 + r * L + i * g - 1)
                                    : Probe{NONE, 0};
        }
      ++taken;
    }
    if (g == 1) break;
  }
#pragma unroll
  for (int r = 0; r < WAYS; ++r) splits[b * WAYS + r] = (uint32_t)cnt[r];
}

// Record a below record b, both in shared memory, where u0 and v0 are
// their plane-0 words (the merge heads'): the other planes are read only on
// equal ones.
template <int P>
__device__ __forceinline__ bool head_lt(const uint64_t* s, int ps,
                                        uint64_t u0, int a, uint64_t v0,
                                        int b) {
  if (u0 != v0) return u0 < v0;
#pragma unroll
  for (int q = 1; q < P; ++q) {
    const uint64_t u = s[q * ps + sk64(a)];
    const uint64_t v = s[q * ps + sk64(b)];
    if (u != v) return u < v;
  }
  return false;
}

// The row a compared word is written to: key word w for w < nk, the
// tie-break row for w == nk, none (-1) past it.
__host__ __device__ constexpr int word_row(int w, int nk, int tb_row) {
  return w < nk ? w : (w == nk ? tb_row : -1);
}

// Shared memory of one four-way block: the two-way block's, and the
// merged order of A with B and of C with D (window positions, as `src`).
inline size_t merge4_smem(int nk, int width) {
  return merge_pass_smem(SLIM_ROWS, nk, width) +
         (size_t)(width + width / 32 + 2) * 2;
}

// The four-way pass: one block of width / K4_V threads per `width` output
// records, which merges groups of four adjacent ascending runs of run_len
// into ascending runs of 4 * run_len (the last group's runs as group_runs
// gives them). The block's ends come from the partition: it merges the
// windows A[a0, a1), B[b0, b1), C[c0, c1), D[e0, e1), of `width` records
// together; the group's last block ends at the runs' ends.
// 1. Load: as the two-way pass, window position k in the window of the run
//    it falls in, every word read once, coalesced.
// 2. Merge A with B and C with D: thread t owns positions [t V, t V + V)
//    of the two merged halves laid end to end (one or two binary searches,
//    then serial steps from register heads), recording window positions in
//    `mid`.
// 3. Merge the two halves as the two-way pass merges A with B, records
//    compared through `mid`; each output's window position goes to `src`.
// 4. Store: every row written once, coalesced, from shared memory, each
//    plane read once an output for the two rows it holds.
// Ties go to A, then to AB: the order of two two-way passes. What bounds
// the block is shared memory, not device memory: it merges twice, so its
// heads carry plane 0 alone (head_lt reads the rest on equal words) and
// its store reads a plane once for both of its rows.
template <int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K1_MAX_WIDTH / K4_V)
    merge4_pass_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ splits, size_t n,
                       int width, size_t run_len) {
  static_assert(R > 0, "the four-way pass fixes the layout");
  constexpr int rows = R, nk = NK, tb_row = TB;
  constexpr int npay = rows - nk - 1;
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int W = width;
  const int ps = W + (W >> 4);
  uint64_t* s = reinterpret_cast<uint64_t*>(sm_raw);
  uint32_t* pay = reinterpret_cast<uint32_t*>(s + (size_t)P * ps);
  uint16_t* src = reinterpret_cast<uint16_t*>(pay + (size_t)npay * W);
  uint16_t* mid = src + (W + W / 32 + 2);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // == W / K4_V
  const size_t L = run_len;
  const size_t out0 = (size_t)blockIdx.x * W;
  const size_t g0 = out0 / (WAYS * L) * (WAYS * L);
  size_t len[WAYS];
  group_runs(n, L, g0, len);
  const bool last_block =
      out0 - g0 + W == len[0] + len[1] + len[2] + len[3];
  const uint32_t* sp = splits + (size_t)blockIdx.x * WAYS;
  int off[WAYS + 1];     // window of run r: positions [off[r], off[r + 1])
  size_t col0[WAYS];     // column of position k in run r's window, less k
  off[0] = 0;
#pragma unroll
  for (int r = 0; r < WAYS; ++r) {
    const size_t s0 = sp[r];
    const size_t s1 = last_block ? len[r] : sp[WAYS + r];
    off[r + 1] = off[r] + (int)(s1 - s0);
    col0[r] = g0 + r * L + s0 - off[r];
  }
  auto column = [&](int k) -> size_t {
    return (k < off[1] ? col0[0]
                       : k < off[2] ? col0[1]
                                    : k < off[3] ? col0[2] : col0[3]) + k;
  };

  for (int p = 0; p < npay; ++p) {
    const int row = p < tb_row - nk ? nk + p : nk + 1 + p;
    const uint32_t* xr = x + (size_t)row * n;
    uint32_t* dst = pay + (size_t)p * W;
#pragma unroll
    for (int j = 0; j < K4_V; ++j) {
      const int k = tid + j * nt;
      cp_async4(dst + k, xr + column(k));
    }
  }
  const uint32_t* xtb = x + (size_t)tb_row * n;
#pragma unroll
  for (int j = 0; j < K4_V; ++j) {
    const int k = tid + j * nt;
    const size_t c = column(k);
    uint64_t rec[P];
    pack_rec<P>(rec, x, n, nk, c, __ldg(xtb + c));
    store_rec<P>(s, ps, k, rec);
  }
  cp_async_wait_all();
  __syncthreads();

  const int h = off[2];  // AB fills mid[0, h), CD mid[h, W)
  for (int p = tid * K4_V, pend = p + K4_V; p < pend;) {
    const bool ab = p < h;
    const int a0 = ab ? 0 : h;
    const int b0 = ab ? off[1] : off[3];
    const int end = ab ? h : W;
    const int na = b0 - a0;
    const int nb = end - b0;
    const int dd = p - a0;
    int lo = dd > nb ? dd - nb : 0;
    int hi = dd < na ? dd : na;
    while (lo < hi) {  // largest i with A[i-1] <= B[dd-i]: ties go to A
      const int m = (lo + hi + 1) >> 1;
      if (!smem_lt<P>(s, ps, b0 + dd - m, a0 + m - 1)) {
        lo = m;
      } else {
        hi = m - 1;
      }
    }
    int pa = a0 + lo;  // window positions of the heads
    int pb = b0 + dd - lo;
    const int a1 = a0 + na;
    uint64_t ha = pa < a1 ? s[sk64(pa)] : 0;
    uint64_t hb = pb < end ? s[sk64(pb)] : 0;
    for (const int stop = pend < end ? pend : end; p < stop; ++p) {
      if (pb >= end || (pa < a1 && !head_lt<P>(s, ps, hb, pb, ha, pa))) {
        mid[sk16(p)] = (uint16_t)pa;
        if (++pa < a1) ha = s[sk64(pa)];
      } else {
        mid[sk16(p)] = (uint16_t)pb;
        if (++pb < end) hb = s[sk64(pb)];
      }
    }
  }
  __syncthreads();

  {
    const int nab = h;
    const int ncd = W - h;
    const int dd = tid * K4_V;
    int lo = dd > ncd ? dd - ncd : 0;
    int hi = dd < nab ? dd : nab;
    while (lo < hi) {  // ties go to AB
      const int m = (lo + hi + 1) >> 1;
      if (!smem_lt<P>(s, ps, mid[sk16(nab + dd - m)], mid[sk16(m - 1)])) {
        lo = m;
      } else {
        hi = m - 1;
      }
    }
    int ia = lo;
    int ib = dd - lo;
    int pa = 0, pb = 0;  // window positions of the heads
    uint64_t ha = 0, hb = 0;
    if (ia < nab) {
      pa = mid[sk16(ia)];
      ha = s[sk64(pa)];
    }
    if (ib < ncd) {
      pb = mid[sk16(nab + ib)];
      hb = s[sk64(pb)];
    }
#pragma unroll
    for (int v = 0; v < K4_V; ++v) {
      if (ib >= ncd || (ia < nab && !head_lt<P>(s, ps, hb, pb, ha, pa))) {
        src[sk16(dd + v)] = (uint16_t)pa;
        if (++ia < nab) {
          pa = mid[sk16(ia)];
          ha = s[sk64(pa)];
        }
      } else {
        src[sk16(dd + v)] = (uint16_t)pb;
        if (++ib < ncd) {
          pb = mid[sk16(nab + ib)];
          hb = s[sk64(pb)];
        }
      }
    }
  }
  __syncthreads();

  int from[K4_V];
#pragma unroll
  for (int j = 0; j < K4_V; ++j) from[j] = src[sk16(tid + j * nt)];
  uint32_t* o = out + out0 + tid;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    constexpr int none = -1;
    const int r0 = word_row(2 * q, nk, tb_row);
    const int r1 = word_row(2 * q + 1, nk, tb_row);
#pragma unroll
    for (int j = 0; j < K4_V; ++j) {
      const uint64_t v = s[q * ps + sk64(from[j])];
      if (r0 != none) o[(size_t)r0 * n + j * nt] = (uint32_t)(v >> 32);
      if (r1 != none) o[(size_t)r1 * n + j * nt] = (uint32_t)v;
    }
  }
  for (int p = 0; p < npay; ++p) {
    const int row = p < tb_row - nk ? nk + p : nk + 1 + p;
    const uint32_t* pr = pay + (size_t)p * W;
#pragma unroll
    for (int j = 0; j < K4_V; ++j) o[(size_t)row * n + j * nt] = pr[from[j]];
  }
}

// The four-way pass's block width: the largest power of two up to
// K1_MAX_WIDTH that divides n and 4 * run_len and whose shared memory fits
// K4's budget.
inline int merge4_width(int nk, size_t n, size_t run_len) {
  if (nk < 1 || nk > 3) return 0;
  size_t w = K1_MAX_WIDTH;
  while (w > (size_t)K4_V &&
         (n % w || (WAYS * run_len) % w ||
          merge4_smem(nk, (int)w) > K4_SMEM_BUDGET))
    w >>= 1;
  return (int)w;
}

template <int P, int R, int NK, int TB> struct Merge4PartitionLaunch {
  static int run(const uint32_t* x, uint32_t* splits, size_t n, int width,
                 size_t run_len, cudaStream_t stream) {
    const size_t blocks = n / width;
    const size_t grid = (blocks + K4_PARTITION_THREADS - 1) /
                        K4_PARTITION_THREADS;
    merge4_partition_kernel<P, R, NK, TB>
        <<<(unsigned)grid, K4_PARTITION_THREADS, 0, stream>>>(
            x, splits, n, width, run_len, blocks);
    return (int)cudaGetLastError();
  }
};

template <int P, int R, int NK, int TB> struct Merge4PassLaunch {
  static int run(const uint32_t* x, uint32_t* out, const uint32_t* splits,
                 size_t n, int width, size_t run_len, cudaStream_t stream) {
    const size_t smem = merge4_smem(NK, width);
    const int err = set_smem((const void*)merge4_pass_kernel<P, R, NK, TB>,
                             smem);
    if (err) return err;
    merge4_pass_kernel<P, R, NK, TB>
        <<<(unsigned)(n / width), width / K4_V, smem, stream>>>(
            x, out, splits, n, width, run_len);
    return (int)cudaGetLastError();
  }
};

// A merge kernel's registers a thread and resident blocks a multiprocessor
// at `width` (the two-way K4 for ways 2, the four-way one for 4).
template <int P, int R, int NK, int TB> struct MergeOccupancy {
  static int run(int ways, int width, int* regs, int* blocks) {
    const void* k = ways == WAYS ? (const void*)merge4_pass_kernel<P, R, NK, TB>
                                 : (const void*)merge_pass_kernel<P, R, NK, TB>;
    const size_t smem = ways == WAYS ? merge4_smem(NK, width)
                                     : merge_pass_smem(R, NK, width);
    int err = set_smem(k, smem);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, k);
    if (err) return err;
    *regs = attr.numRegs;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k, width / (ways == WAYS ? K4_V : K1_V), smem);
  }
};

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

// K3 reading the nk key words of row-major records in place:
// words uint32[n_real, stride] (stride >= nk), out the [4, m] layout (m a
// multiple of tile, at least n_real), columns n_real.. padding with
// all-0xFFFFFFFF keys and rows nk..2 zero: the bytes uda_tile_sort_folded
// writes for the [4, m] matrix of those keys.
int uda_tile_sort_folded_rows(const void* words, size_t n_real,
                              size_t stride, void* out, size_t m, int nk,
                              int tile, void* stream) {
  return dispatch_slim<TileSortRecordsLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)words, n_real,
      stride, (uint32_t*)out, m, tile, (cudaStream_t)stream);
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

// The four-way pass's block width for one pass (merge4_width); 0 for a key
// count K4 does not take.
int uda_merge_pass4_folded_width(int nk, size_t n, size_t run_len) {
  return merge4_width(nk, n, run_len);
}

// The four-way partition: splits uint32[n / width, 4], each boundary's A,
// B, C and D counts.
int uda_merge_partition4_folded(const void* x, void* splits, size_t n,
                                int nk, int width, size_t run_len,
                                void* stream) {
  return dispatch_slim<Merge4PartitionLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)splits,
      n, width, run_len, (cudaStream_t)stream);
}

// `splits` from uda_merge_partition4_folded at the same width.
int uda_merge_pass4_folded(const void* x, void* out, const void* splits,
                           size_t n, int nk, int width, size_t run_len,
                           void* stream) {
  return dispatch_slim<Merge4PassLaunch>(
      nk, (int)cudaErrorInvalidValue, (const uint32_t*)x, (uint32_t*)out,
      (const uint32_t*)splits, n, width, run_len, (cudaStream_t)stream);
}

// Registers a thread and resident blocks a multiprocessor of K4's merge
// kernel, two-way (ways 2) or four-way (4), at `width` records a block.
int uda_merge_pass_folded_occupancy(int nk, int ways, int width, int* regs,
                                    int* blocks) {
  return dispatch_slim<MergeOccupancy>(nk, (int)cudaErrorInvalidValue, ways,
                                       width, regs, blocks);
}

}  // extern "C"
