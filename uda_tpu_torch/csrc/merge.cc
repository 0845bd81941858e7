// The port's copy of uda_tpu/native/merge.cc (same C ABI, same bytes).
// Native streaming k-way merge: the RPQ final-merge hot path.
//
// C++ equivalent of the reference's MergeQueue loser-walk over
// SuperSegment file cursors (reference src/Merger/MergeQueue.h:276-427
// feeding write_kv_to_stream, src/Merger/StreamRW.cc:151-225): k sorted
// IFile spill files stream through buffered cursors into a loser tree;
// the winning record's framed bytes are copied VERBATIM into the output
// block (framing is canonical, so verbatim copy == re-encode, and it is
// byte-identical to the Python heap path in uda_tpu_torch/ops/merge.py by
// construction). Comparator semantics are the CompareFunc.cc family
// (reference src/Merger/CompareFunc.cc:70-113) expressed as key "modes"
// — see kway_key_mode in uda_tpu_torch/native/__init__.py:
//   0 identity  — memcmp over the serialized key
//   1 text      — skip the VInt length prefix, then memcmp
//   2 bytes     — skip the 4-byte length prefix, then memcmp
//   3 flipsign  — first key_param bytes with byte 0 XOR 0x80 (the
//                 numeric-order variants), then memcmp
// All modes share the memcmp + shorter-is-smaller rule with ties broken
// by cursor index (stable by segment order, matching
// merge_record_streams' seq tiebreak).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <vector>

#include "vlong.h"

namespace {

constexpr int64_t kErrCorrupt = -1;   // bad framing / missing EOF marker
constexpr int64_t kErrTooSmall = -3;  // record larger than the out block
constexpr int64_t kErrIo = -4;        // read() failure

// Sanity bound on a single key/value length: a corrupt VLong must fail
// as kErrCorrupt, not overflow int64 arithmetic or balloon the cursor
// buffer until bad_alloc escapes the C boundary.
constexpr int64_t kMaxPartLen = int64_t{1} << 30;  // 1 GiB

// One spill-file cursor: buffered sequential reads, one parsed record
// at a time (rec/key offsets point into buf and stay valid until the
// cursor's own next advance — the merge copies the record out before
// advancing, so no other cursor can invalidate them).
struct Cursor {
  int fd = -1;
  std::vector<uint8_t> buf;
  int64_t pos = 0;       // parse position
  int64_t filled = 0;    // valid bytes in buf
  bool file_done = false;
  bool exhausted = false;  // saw the (-1,-1) EOF marker
  int64_t rec_off = 0, rec_len = 0;  // current framed record
  int64_t key_off = 0, key_len = 0;  // serialized key within buf

  // Compact the unparsed tail to the front and read more. Returns
  // bytes added, 0 at file end, <0 on errno.
  int64_t refill() {
    if (pos > 0) {
      std::memmove(buf.data(), buf.data() + pos, filled - pos);
      filled -= pos;
      pos = 0;
    }
    if (filled == static_cast<int64_t>(buf.size())) {
      buf.resize(buf.size() * 2);  // record larger than the buffer
    }
    ssize_t n = read(fd, buf.data() + filled, buf.size() - filled);
    if (n < 0) return kErrIo;
    if (n == 0) {
      file_done = true;
      return 0;
    }
    filled += n;
    return n;
  }

  // Parse the record at pos (refilling as needed). Returns 0 ok /
  // negative error; sets exhausted at the EOF marker.
  int64_t advance() {
    for (;;) {
      int64_t klen, vlen;
      int64_t start = pos;
      int used = uda::decode_vlong(buf.data(), filled, pos, &klen);
      if (used) {
        int64_t p = start + used;
        int used2 = uda::decode_vlong(buf.data(), filled, p, &vlen);
        if (used2) {
          p += used2;
          if (klen == -1 && vlen == -1) {
            pos = p;
            exhausted = true;
            return 0;
          }
          if (klen < 0 || vlen < 0 ||
              klen > kMaxPartLen || vlen > kMaxPartLen) {
            return kErrCorrupt;
          }
          if (p + klen + vlen <= filled) {
            rec_off = start;
            rec_len = (p + klen + vlen) - start;
            key_off = p;
            key_len = klen;
            pos = p + klen + vlen;
            return 0;
          }
        }
      }
      // truncated mid-record: need more bytes
      if (file_done) return kErrCorrupt;  // missing EOF marker
      int64_t n = refill();
      if (n < 0) return n;
      if (file_done && pos >= filled) return kErrCorrupt;
    }
  }
};

struct KwayMerger {
  std::vector<Cursor> cur;
  std::vector<int> node;  // loser tree: node[1..k-1] losers, leaves k..2k-1
  int winner = -1;
  int key_mode = 0;
  int key_param = 0;
  int64_t err = 0;  // first cursor error, sticky

  // Comparable content view of cursor i's current key (mode applied).
  void content(int i, const uint8_t** p, int64_t* n) const {
    const Cursor& c = cur[i];
    const uint8_t* k = c.buf.data() + c.key_off;
    int64_t kl = c.key_len;
    switch (key_mode) {
      case 1: {  // Text: skip the VInt prefix (CompareFunc.cc:82-86)
        int64_t clen;
        int used = uda::decode_vlong(k, kl, 0, &clen);
        if (!used || clen < 0) { *p = k; *n = 0; return; }
        *p = k + used;
        *n = std::min(clen, kl - used);
        return;
      }
      case 2:  // BytesWritable: skip the 4-byte length (:89-91)
        *p = k + std::min<int64_t>(4, kl);
        *n = std::max<int64_t>(0, kl - 4);
        return;
      case 3:  // numeric variants: first key_param bytes, byte0 ^ 0x80
        *p = k;
        *n = std::min<int64_t>(key_param, kl);
        return;
      default:
        *p = k;
        *n = kl;
        return;
    }
  }

  // true when cursor a's record sorts strictly before cursor b's.
  // Exhausted cursors sort after everything.
  bool beats(int a, int b) const {
    if (cur[a].exhausted) return false;
    if (cur[b].exhausted) return true;
    const uint8_t *pa, *pb;
    int64_t na, nb;
    content(a, &pa, &na);
    content(b, &pb, &nb);
    int64_t n = std::min(na, nb);
    if (n > 0) {
      uint8_t xa = pa[0], xb = pb[0];
      if (key_mode == 3) { xa ^= 0x80; xb ^= 0x80; }
      if (xa != xb) return xa < xb;
      int c = std::memcmp(pa + 1, pb + 1, n - 1);
      if (c) return c < 0;
    }
    if (na != nb) return na < nb;  // shorter-is-smaller
    return a < b;                  // stable by segment order
  }

  void build_tree() {
    int k = static_cast<int>(cur.size());
    if (k == 1) {
      winner = 0;
      return;
    }
    node.assign(2 * k, -1);
    std::vector<int> win(2 * k);
    for (int j = k; j < 2 * k; ++j) win[j] = j - k;
    for (int j = k - 1; j >= 1; --j) {
      int a = win[2 * j], b = win[2 * j + 1];
      if (beats(a, b)) {
        win[j] = a;
        node[j] = b;
      } else {
        win[j] = b;
        node[j] = a;
      }
    }
    winner = win[1];
  }

  // Re-play the winner's leaf-to-root path after its cursor advanced.
  void replay() {
    int k = static_cast<int>(cur.size());
    if (k == 1) return;
    int c = winner;
    for (int j = (winner + k) / 2; j >= 1; j /= 2) {
      if (beats(node[j], c)) std::swap(node[j], c);
    }
    winner = c;
  }
};

}  // namespace

extern "C" {

// Open the k spill files and prime every cursor. Returns NULL on
// failure with *err distinguishing the cause: kErrIo for open()/read()
// failures, kErrCorrupt for bad framing in a first record (partially
// opened fds are closed either way).
void* uda_kway_create(const char* const* paths, int32_t n,
                      int32_t key_mode, int32_t key_param,
                      int64_t buffer_size, int64_t* err) {
  if (err) *err = 0;
  if (n <= 0 || buffer_size < 64) {
    if (err) *err = kErrIo;
    return nullptr;
  }
  auto* m = new KwayMerger();
  m->key_mode = key_mode;
  m->key_param = key_param;
  m->cur.resize(n);
  for (int i = 0; i < n; ++i) {
    Cursor& c = m->cur[i];
    c.fd = open(paths[i], O_RDONLY);
    if (c.fd < 0) {
      if (err) *err = kErrIo;
      for (int j = 0; j <= i; ++j)
        if (m->cur[j].fd >= 0) close(m->cur[j].fd);
      delete m;
      return nullptr;
    }
    c.buf.resize(buffer_size);
  }
  for (int i = 0; i < n; ++i) {
    int64_t rc = m->cur[i].advance();
    if (rc < 0) {
      if (err) *err = rc;
      for (auto& c : m->cur) close(c.fd);
      delete m;
      return nullptr;
    }
  }
  m->build_tree();
  return m;
}

// Fill `out` with as many whole framed records as fit. Returns bytes
// written; 0 = end of stream (all cursors exhausted; no EOF marker is
// appended — the caller owns stream-level framing); kErrTooSmall with
// *need set when the next record alone exceeds cap; kErrCorrupt/kErrIo
// on cursor failure (sticky).
int64_t uda_kway_next_block(void* h, uint8_t* out, int64_t cap,
                            int64_t* need) {
  auto* m = static_cast<KwayMerger*>(h);
  if (m->err) return m->err;
  int64_t written = 0;
  while (m->winner >= 0) {
    Cursor& c = m->cur[m->winner];
    if (c.exhausted) break;  // winner exhausted => all exhausted
    if (written + c.rec_len > cap) {
      if (written == 0) {
        if (need) *need = c.rec_len;
        return kErrTooSmall;
      }
      break;
    }
    std::memcpy(out + written, c.buf.data() + c.rec_off, c.rec_len);
    written += c.rec_len;
    int64_t rc = c.advance();
    if (rc < 0) {
      m->err = rc;
      return rc;
    }
    m->replay();
  }
  return written;
}

void uda_kway_destroy(void* h) {
  auto* m = static_cast<KwayMerger*>(h);
  if (!m) return;
  for (auto& c : m->cur)
    if (c.fd >= 0) close(c.fd);
  delete m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Row merge: two sorted uint32-row matrices -> one, lexicographic by all
// columns, ties to A (stability). The host-engine twin of the Pallas
// merge-path kernel for the overlap run forest (uda_tpu_torch/merger/overlap.py):
// a linear two-pointer pass instead of re-lexsorting the concatenation.
// ---------------------------------------------------------------------------

extern "C" void uda_merge_rows(const uint32_t* a, int64_t na,
                               const uint32_t* b, int64_t nb,
                               int32_t k, uint32_t* out) {
  const size_t row = (size_t)k * sizeof(uint32_t);
  int64_t i = 0, j = 0;
  while (i < na && j < nb) {
    const uint32_t* pa = a + (size_t)i * k;
    const uint32_t* pb = b + (size_t)j * k;
    bool a_le_b = true;
    for (int32_t c = 0; c < k; ++c) {
      if (pa[c] != pb[c]) { a_le_b = pa[c] < pb[c]; break; }
    }
    if (a_le_b) {
      std::memcpy(out, pa, row);
      ++i;
    } else {
      std::memcpy(out, pb, row);
      ++j;
    }
    out += k;
  }
  if (i < na) {
    std::memcpy(out, a + (size_t)i * k, (size_t)(na - i) * row);
  } else if (j < nb) {
    std::memcpy(out, b + (size_t)j * k, (size_t)(nb - j) * row);
  }
}
