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
// K4, multiway (merge_ways_pass_kernel after merge_ways_partition_kernel,
//   each a template over WAYS, 4 or 8): a pass merges groups of WAYS
//   adjacent runs into one, so a cascade takes a half or a third of the
//   two-way passes at the same 32 B a column a pass (pallas_fold.merge_plan:
//   the fewest passes, eight-way, one of them four-way where they leave
//   room for it, first). Its output is the two-way passes' (ties to the
//   earlier run), byte for byte.
//   The partition finds each block boundary's WAYS splits at once by a
//   multiway selection on the power-of-two grid (below), one thread a
//   boundary; a block loads exactly its WAYS windows, merges them in
//   shared memory by a tree of log2(WAYS) two-way levels (A with B, C with
//   D, ..., then the results), and writes every row once. The two-way
//   kernels above and in lanes_common.cuh are the ones K1 and K4's
//   two-way passes run, unchanged.

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

// ---------------------------------------- multiway merge passes (K4)

constexpr int K4_V = 8;             // multiway outputs a thread (16: slower)
constexpr int K4_PARTITION_THREADS = 128;
// The multiway block's widest window, and the blocks a multiprocessor the
// eight-way kernel is held to: the shared memory of 2048 records (42-44 KB
// at every key count) holds 5, and the bound caps its registers at 48 so
// that they hold 5 too (it takes 56 uncapped, 4 blocks, and runs 11%
// slower; the four-way kernel runs no faster capped). 4096 records a block
// (2 blocks) were slower still.
constexpr int K4_WAYS_MAX_WIDTH = 2048;
constexpr int K4_EIGHT_WAY_BLOCKS = 5;

// The WAYS runs of the group that starts at column g0 of a pass over n
// columns with runs of L, as pair_runs takes a pair's: L each where the
// group lies wholly inside n; a cascade on a whole number of blocks ends in
// a group whose last runs are short or empty (a group of one run copies
// it).
template <int WAYS>
__device__ __forceinline__ void group_runs(size_t n, size_t L, size_t g0,
                                           size_t (&len)[WAYS]) {
#pragma unroll
  for (int r = 0; r < WAYS; ++r) {
    const size_t start = g0 + r * L;
    const size_t left = n > start ? n - start : 0;
    len[r] = left < L ? left : L;
  }
}

// A record the partition compares, by its offset in the group and its
// first key word, or none (off == NONE). Offsets and counts are 32-bit: a
// group holds fewer than 2^32 columns (the arrival index's range), and a
// multiway pass has three or more runs, so its runs are under 2^31 long.
struct Probe {
  uint32_t off;
  uint32_t w0;
};
constexpr uint32_t NONE = ~0u;

__device__ __forceinline__ Probe probe_at(const uint32_t* __restrict__ xg,
                                          uint32_t off) {
  return {off, __ldg(xg + off)};
}

// a before b in a multiway pass's order: (key words, tie-break), then the
// column, so equal records keep their runs' order (A before B before C ...)
// and each run's own. The first key words decide almost every compare; on
// equal ones the other words are loaded at once. xg is the group's first
// column of row 0.
template <int NK, int TB>
__device__ __forceinline__ bool probe_before(const uint32_t* __restrict__ xg,
                                             size_t n, const Probe& a,
                                             const Probe& b) {
  if (a.w0 != b.w0) return a.w0 < b.w0;
  uint32_t u[NK], v[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {  // words 1..NK-1, then the tie-break
    const size_t row = (size_t)(k + 1 < NK ? k + 1 : TB) * n;
    u[k] = __ldg(xg + row + a.off);
    v[k] = __ldg(xg + row + b.off);
  }
#pragma unroll
  for (int k = 0; k < NK; ++k)
    if (u[k] != v[k]) return u[k] < v[k];
  return a.off < b.off;
}

// The multiway partition: for every block boundary (output column
// b * width), the numbers of records of each of the group's WAYS runs among
// its first d merged records (d = its diagonal), ties to the earlier run;
// they sum to d.
//
// Design: a multiway selection on the power-of-two grid (the refinement of
// Varman et al.'s multisequence selection that GNU libstdc++'s parallel
// mode runs as multiseq_partition). At grid g, a run's samples are its
// records g - 1, 2g - 1, ... (the last of each whole g-chunk); cnt[r] is
// how many of run r's samples lie in the floor(d / g) smallest samples of
// the group. From g to g / 2, run r's samples are its old ones and one new
// sample between each two: the new ones below x*, the largest sample
// taken at g, join (one compare each: only the one after a run's last
// taken sample is in question), then at most WAYS of the largest taken
// leave, or one of the smallest left joins, until floor(d / (g / 2)) are
// taken. At g = 1 the samples are the records, and cnt is the split.
//
// What bounds it: one thread's chain of levels (a pass's boundaries fit in
// one wave: 48,830 at 10^8), each level's dependent reads and its serial
// scans over the WAYS runs. A level reads the WAYS new samples and the
// sample before x*, which the first leaver needs, all at once; a second
// leaver from one run, or a joiner, reads one more; log2(L) + 1 levels.
// More state a thread costs more than it saves: reading the sample before
// every run's last, or keeping it in registers, was slower (the second
// needs 186 registers, so 2 blocks of 128 threads an SM and a second wave);
// 32-bit offsets (96 registers, not 166) were 9% faster.
template <int WAYS, int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K4_PARTITION_THREADS)
    merge_ways_partition_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ splits, size_t n,
                                int width, size_t run_len, size_t blocks) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const size_t out0 = b * width;
  const size_t g0 = out0 / (WAYS * run_len) * (WAYS * run_len);
  const uint32_t d = (uint32_t)(out0 - g0);
  const uint32_t L = (uint32_t)run_len;
  const uint32_t* __restrict__ xg = x + g0;
  size_t glen[WAYS];
  group_runs<WAYS>(n, run_len, g0, glen);
  uint32_t len[WAYS], cnt[WAYS];
  Probe last[WAYS], next[WAYS];  // per run: the last sample taken, the next
#pragma unroll
  for (int r = 0; r < WAYS; ++r) {
    len[r] = (uint32_t)glen[r];
    cnt[r] = 0;
    last[r] = next[r] = Probe{NONE, 0};
  }
  // at grid 2L no run has a sample: start there, with none taken
  for (uint32_t g = L; d; g >>= 1) {
    int top = -1;  // the run of x*
    Probe xs{NONE, 0};
#pragma unroll
    for (int r = 0; r < WAYS; ++r)
      if (last[r].off != NONE &&
          (top < 0 || probe_before<NK, TB>(xg, n, xs, last[r]))) {
        top = r;
        xs = last[r];
      }
    Probe odd[WAYS];
    Probe pre{NONE, 0};
    uint32_t pre_idx = 0;
#pragma unroll
    for (int r = 0; r < WAYS; ++r) {
      const uint32_t base = r * L;
      const uint32_t i = 2 * cnt[r] + 1;  // the new sample after the last
      odd[r] = i * g <= len[r] ? probe_at(xg, base + i * g - 1)
                               : Probe{NONE, 0};
      if (r == top) {  // cnt[top] >= 1: x* is its sample cnt[top]
        pre_idx = 2 * cnt[r] - 1;
        pre = probe_at(xg, base + pre_idx * g - 1);
      }
    }
    uint32_t taken = 0;
#pragma unroll
    for (int r = 0; r < WAYS; ++r) {
      cnt[r] *= 2;
      if (top >= 0 && odd[r].off != NONE &&
          probe_before<NK, TB>(xg, n, odd[r], xs)) {
        ++cnt[r];
        last[r] = odd[r];  // next stays: the old next, sample 2 cnt + 2
      } else {
        next[r] = odd[r];  // none where the run has no such sample
      }
      taken += cnt[r];
    }
    const uint32_t want = d / g;
    while (taken > want) {  // the largest taken leaves
      int hi = -1;
      Probe hv{NONE, 0};
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (last[r].off != NONE &&
            (hi < 0 || probe_before<NK, TB>(xg, n, hv, last[r]))) {
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
            last[r] = probe_at(xg, r * L + cnt[r] * g - 1);
        }
      --taken;
    }
    while (taken < want) {  // the smallest left joins
      int lo = -1;
      Probe lv{NONE, 0};
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (next[r].off != NONE &&
            (lo < 0 || probe_before<NK, TB>(xg, n, next[r], lv))) {
          lo = r;
          lv = next[r];
        }
      if (lo < 0) break;  // only on runs that do not ascend
#pragma unroll
      for (int r = 0; r < WAYS; ++r)
        if (r == lo) {
          last[r] = next[r];
          ++cnt[r];
          const uint32_t i = cnt[r] + 1;
          next[r] = i * g <= len[r] ? probe_at(xg, r * L + i * g - 1)
                                    : Probe{NONE, 0};
        }
      ++taken;
    }
    if (g == 1) break;
  }
#pragma unroll
  for (int r = 0; r < WAYS; ++r) splits[b * WAYS + r] = cnt[r];
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

// Shared memory of one multiway block, four-way or eight-way: the two-way
// block's, and a second array of window positions beside `src`, the levels
// of the block's merge tree writing to the two in turn.
inline size_t merge_ways_smem(int nk, int width) {
  return merge_pass_smem(SLIM_ROWS, nk, width) +
         (size_t)(width + width / 32 + 2) * 2;
}

// One level of a multiway block's merge tree but its last: merges of two
// sequences of HALF windows each, side by side, merge j taking the
// positions [off[2 j HALF], off[(2 j + 1) HALF]) as its A and the rest up
// to off[(2 j + 2) HALF] as its B. Thread t owns positions [t V, t V + V)
// of the merges laid end to end (a binary search for each merge its
// positions fall in, then serial steps from register heads) and writes each
// output's window position to `to`. DIRECT: the sequences are the windows
// themselves (the first level); else level positions, read through `in`.
// Ties go to A.
template <int P, int WAYS, int HALF, bool DIRECT>
__device__ __forceinline__ void merge_level(const uint64_t* s, int ps,
                                            const int (&off)[WAYS + 1],
                                            const uint16_t* in,
                                            uint16_t* to, int tid) {
  auto at = [&](int i) -> int { return DIRECT ? i : in[sk16(i)]; };
  for (int p = tid * K4_V, pend = p + K4_V; p < pend;) {
    int a0 = 0, b0 = off[HALF], end = off[2 * HALF];
#pragma unroll
    for (int j = 2 * HALF; j < WAYS; j += 2 * HALF)
      if (p >= off[j]) {
        a0 = off[j];
        b0 = off[j + HALF];
        end = off[j + 2 * HALF];
      }
    const int na = b0 - a0;
    const int nb = end - b0;
    const int dd = p - a0;
    int lo = dd > nb ? dd - nb : 0;
    int hi = dd < na ? dd : na;
    while (lo < hi) {  // largest i with A[i-1] <= B[dd-i]: ties go to A
      const int m = (lo + hi + 1) >> 1;
      if (!smem_lt<P>(s, ps, at(b0 + dd - m), at(a0 + m - 1))) {
        lo = m;
      } else {
        hi = m - 1;
      }
    }
    int ia = a0 + lo;  // level positions of the heads
    int ib = b0 + dd - lo;
    int ra = 0, rb = 0;  // their window positions
    uint64_t ha = 0, hb = 0;
    if (ia < b0) {
      ra = at(ia);
      ha = s[sk64(ra)];
    }
    if (ib < end) {
      rb = at(ib);
      hb = s[sk64(rb)];
    }
    for (const int stop = pend < end ? pend : end; p < stop; ++p) {
      if (ib >= end || (ia < b0 && !head_lt<P>(s, ps, hb, rb, ha, ra))) {
        to[sk16(p)] = (uint16_t)ra;
        if (++ia < b0) {
          ra = at(ia);
          ha = s[sk64(ra)];
        }
      } else {
        to[sk16(p)] = (uint16_t)rb;
        if (++ib < end) {
          rb = at(ib);
          hb = s[sk64(rb)];
        }
      }
    }
  }
}

// The multiway pass: one block of width / K4_V threads per `width` output
// records, which merges groups of WAYS (4 or 8) adjacent ascending runs of
// run_len into ascending runs of WAYS * run_len (the last group's runs as
// group_runs gives them). The block's ends come from the partition: it
// merges the WAYS windows of `width` records in all; the group's last
// block ends at the runs' ends.
// 1. Load: as the two-way pass, window position k in the window of the run
//    it falls in, every word read once, coalesced.
// 2. Merge in shared memory by a tree of log2(WAYS) levels: the runs in
//    pairs (A with B, C with D, ...), then pairs of those, each level
//    recording window positions (merge_level), the first into `src` or
//    `mid` so that the last but one writes `mid`.
// 3. Merge the two halves as the two-way pass merges A with B, records
//    compared through `mid`; each output's window position goes to `src`.
// 4. Store: every row written once, coalesced, from shared memory, each
//    plane read once an output for the two rows it holds.
// Ties go to the earlier run, then to the earlier merged half: the order of
// log2(WAYS) two-way passes. What bounds the block is shared memory, not
// device memory: it merges log2(WAYS) times, so its heads carry plane 0
// alone (head_lt reads the rest on equal words) and its store reads a
// plane once for both of its rows.
template <int WAYS, int P, int R, int NK, int TB>
__global__ void __launch_bounds__(K4_WAYS_MAX_WIDTH / K4_V,
                                  WAYS == 8 ? K4_EIGHT_WAY_BLOCKS : 1)
    merge_ways_pass_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out,
                           const uint32_t* __restrict__ splits, size_t n,
                           int width, size_t run_len) {
  static_assert(R > 0, "the multiway pass fixes the layout");
  static_assert(WAYS == 4 || WAYS == 8, "four or eight runs a group");
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
  group_runs<WAYS>(n, L, g0, len);
  size_t total = 0;
#pragma unroll
  for (int r = 0; r < WAYS; ++r) total += len[r];
  const bool last_block = out0 - g0 + W == total;
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
    size_t c = col0[0];
#pragma unroll
    for (int r = 1; r < WAYS; ++r)
      if (k >= off[r]) c = col0[r];
    return c + k;
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

  if constexpr (WAYS == 8) {
    merge_level<P, WAYS, 1, true>(s, ps, off, nullptr, src, tid);
    __syncthreads();
    merge_level<P, WAYS, 2, false>(s, ps, off, src, mid, tid);
  } else {
    merge_level<P, WAYS, 1, true>(s, ps, off, nullptr, mid, tid);
  }
  __syncthreads();

  {
    const int nab = off[WAYS / 2];  // the first half fills mid[0, nab)
    const int ncd = W - nab;
    const int dd = tid * K4_V;
    int lo = dd > ncd ? dd - ncd : 0;
    int hi = dd < nab ? dd : nab;
    while (lo < hi) {  // ties go to the first half
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

// The multiway pass's block width: the largest power of two up to
// K4_WAYS_MAX_WIDTH that divides n and ways * run_len and whose shared
// memory fits K4's budget; 0 for a key count or a number of ways it does
// not take.
inline int merge_ways_width(int nk, int ways, size_t n, size_t run_len) {
  if (nk < 1 || nk > 3 || (ways != 4 && ways != 8)) return 0;
  size_t w = K4_WAYS_MAX_WIDTH;
  while (w > (size_t)K4_V &&
         (n % w || (ways * run_len) % w ||
          merge_ways_smem(nk, (int)w) > K4_SMEM_BUDGET))
    w >>= 1;
  return (int)w;
}

// The multiway kernels of `ways` (4 or 8) runs a group, chosen at run time.
template <int P, int R, int NK, int TB> struct MergeWaysPartitionLaunch {
  template <int WAYS>
  static int at(const uint32_t* x, uint32_t* splits, size_t n, int width,
                size_t run_len, cudaStream_t stream) {
    const size_t blocks = n / width;
    const size_t grid = (blocks + K4_PARTITION_THREADS - 1) /
                        K4_PARTITION_THREADS;
    merge_ways_partition_kernel<WAYS, P, R, NK, TB>
        <<<(unsigned)grid, K4_PARTITION_THREADS, 0, stream>>>(
            x, splits, n, width, run_len, blocks);
    return (int)cudaGetLastError();
  }
  static int run(int ways, const uint32_t* x, uint32_t* splits, size_t n,
                 int width, size_t run_len, cudaStream_t stream) {
    switch (ways) {
      case 4: return at<4>(x, splits, n, width, run_len, stream);
      case 8: return at<8>(x, splits, n, width, run_len, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

template <int P, int R, int NK, int TB> struct MergeWaysPassLaunch {
  template <int WAYS>
  static int at(const uint32_t* x, uint32_t* out, const uint32_t* splits,
                size_t n, int width, size_t run_len, cudaStream_t stream) {
    const size_t smem = merge_ways_smem(NK, width);
    const int err = set_smem(
        (const void*)merge_ways_pass_kernel<WAYS, P, R, NK, TB>, smem);
    if (err) return err;
    merge_ways_pass_kernel<WAYS, P, R, NK, TB>
        <<<(unsigned)(n / width), width / K4_V, smem, stream>>>(
            x, out, splits, n, width, run_len);
    return (int)cudaGetLastError();
  }
  static int run(int ways, const uint32_t* x, uint32_t* out,
                 const uint32_t* splits, size_t n, int width, size_t run_len,
                 cudaStream_t stream) {
    switch (ways) {
      case 4: return at<4>(x, out, splits, n, width, run_len, stream);
      case 8: return at<8>(x, out, splits, n, width, run_len, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// A merge kernel's registers a thread and resident blocks a multiprocessor
// at `width` (the two-way K4 for ways 2, the multiway one for 4 and 8).
template <int P, int R, int NK, int TB> struct MergeOccupancy {
  static int run(int ways, int width, int* regs, int* blocks) {
    const void* k;
    switch (ways) {
      case 2: k = (const void*)merge_pass_kernel<P, R, NK, TB>; break;
      case 4: k = (const void*)merge_ways_pass_kernel<4, P, R, NK, TB>; break;
      case 8: k = (const void*)merge_ways_pass_kernel<8, P, R, NK, TB>; break;
      default: return (int)cudaErrorInvalidValue;
    }
    const size_t smem = ways == 2 ? merge_pass_smem(R, NK, width)
                                  : merge_ways_smem(NK, width);
    int err = set_smem(k, smem);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, k);
    if (err) return err;
    *regs = attr.numRegs;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k, width / (ways == 2 ? K1_V : K4_V), smem);
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

// The multiway pass's block width for one pass of `ways` (4 or 8) runs a
// group (merge_ways_width); 0 for a key count or a number of ways K4 does
// not take.
int uda_merge_ways_folded_width(int nk, int ways, size_t n, size_t run_len) {
  return merge_ways_width(nk, ways, n, run_len);
}

// The multiway partition: splits uint32[n / width, ways], each boundary's
// count of every run of its group.
int uda_merge_partition_ways_folded(const void* x, void* splits, size_t n,
                                    int nk, int ways, int width,
                                    size_t run_len, void* stream) {
  return dispatch_slim<MergeWaysPartitionLaunch>(
      nk, (int)cudaErrorInvalidValue, ways, (const uint32_t*)x,
      (uint32_t*)splits, n, width, run_len, (cudaStream_t)stream);
}

// `splits` from uda_merge_partition_ways_folded at the same ways and width.
int uda_merge_pass_ways_folded(const void* x, void* out, const void* splits,
                               size_t n, int nk, int ways, int width,
                               size_t run_len, void* stream) {
  return dispatch_slim<MergeWaysPassLaunch>(
      nk, (int)cudaErrorInvalidValue, ways, (const uint32_t*)x,
      (uint32_t*)out, (const uint32_t*)splits, n, width, run_len,
      (cudaStream_t)stream);
}

// Registers a thread and resident blocks a multiprocessor of K4's merge
// kernel, two-way (ways 2), four-way (4) or eight-way (8), at `width`
// records a block.
int uda_merge_pass_folded_occupancy(int nk, int ways, int width, int* regs,
                                    int* blocks) {
  return dispatch_slim<MergeOccupancy>(nk, (int)cudaErrorInvalidValue, ways,
                                       width, regs, blocks);
}

}  // extern "C"
