// The port's copy of uda_tpu/native/lzo.cc (same C ABI, same bytes).
// Native LZO1X block codec: the in-tree stand-in for liblzo2.
//
// The reference dlopen'd liblzo2 at runtime (reference
// src/Merger/LzoDecompressor.cc:83-127) and treated its absence as a
// runtime condition. This file makes the native path self-contained:
// an independent implementation of the LZO1X stream format (the token
// grammar is documented in uda_tpu_torch/compress/lzo.py, whose pure-Python
// decoder is the semantic reference these entry points are
// parity-tested against, tests/test_torch_native.py). Exported under
// uda_-prefixed names so a real liblzo2, when present in the process,
// never collides; uda_tpu_torch/compress/lzo.py prefers the system library
// and falls back here.
//
// Grammar recap (matching the Python decoder's state machine):
//   stream   := [initial-literals] { match [state-literals] | run match }
//               EOS
//   M2 token >=64: len 3..8, dist <= 0x808, state in token low bits
//   M3 token 32..63: len >= 3 (extended), dist <= 0x4000, 2-byte LE
//              distance field, state in d0 low bits
//   M4 token 16..31: dist 0x4001..0xBFFF (dist-0x4000 == 0 is EOS),
//              len >= 3 (extended), state in d0 low bits
//   run token < 16: literal run >= 4 (extended); runs of 1..3 ride the
//              previous match token's state bits
//   EOS      := 0x11 0x00 0x00

#include <cstdint>
#include <cstring>

extern "C" {

// error codes mirror lzo.h's public values for familiarity
enum {
  UDA_LZO_OK = 0,
  UDA_LZO_E_INPUT_OVERRUN = -4,
  UDA_LZO_E_OUTPUT_OVERRUN = -5,
  UDA_LZO_E_LOOKBEHIND_OVERRUN = -6,
  UDA_LZO_E_EOF_NOT_FOUND = -7,
  UDA_LZO_E_INPUT_NOT_CONSUMED = -8,
};

// ---------------------------------------------------------------------------
// decompressor (safe: every read/write bounds-checked)
// ---------------------------------------------------------------------------

int uda_lzo1x_decompress_safe(const uint8_t* src, size_t src_len,
                              uint8_t* dst, size_t* dst_len) {
  const size_t cap = *dst_len;
  size_t ip = 0, op = 0;
  *dst_len = 0;

#define NEED_IN(n) if (ip + (n) > src_len) return UDA_LZO_E_INPUT_OVERRUN
#define NEED_OUT(n) if (op + (n) > cap) return UDA_LZO_E_OUTPUT_OVERRUN

  // extended length: zero bytes each add 255, final nonzero byte adds
  // itself; `base` is the token-family bias
  auto extended = [&](size_t base, int* err) -> size_t {
    size_t t = 0;
    for (;;) {
      if (ip >= src_len) { *err = UDA_LZO_E_INPUT_OVERRUN; return 0; }
      uint8_t b = src[ip++];
      if (b == 0) {
        t += 255;
        if (t > (1u << 30)) { *err = UDA_LZO_E_INPUT_OVERRUN; return 0; }
      } else {
        return t + base + b;
      }
    }
  };

  int err = UDA_LZO_OK;
  size_t t;
  int state;          // trailing literal count after a match
  enum { LOOP, FIRST, MATCH } mode = LOOP;

  NEED_IN(1);
  if (src[0] > 17) {
    ip = 1;
    t = src[0] - 17;
    NEED_IN(t); NEED_OUT(t);
    std::memcpy(dst + op, src + ip, t); op += t; ip += t;
    NEED_IN(1);
    t = src[ip++];
    // short initial run < 4 -> the next token is a match token; else
    // first_literal_run semantics — same split as the Python decoder
    mode = (src[0] - 17 < 4) ? MATCH : FIRST;
  } else {
    t = 0;
  }

  for (;;) {
    if (mode == LOOP) {
      NEED_IN(1);
      t = src[ip++];
      if (t < 16) {
        if (t == 0) { t = extended(15, &err); if (err) return err; }
        t += 3;
        NEED_IN(t); NEED_OUT(t);
        std::memcpy(dst + op, src + ip, t); op += t; ip += t;
        NEED_IN(1);
        t = src[ip++];
        mode = FIRST;
        continue;
      }
      mode = MATCH;
      continue;
    }

    if (mode == FIRST) {
      if (t < 16) {
        // special M1 right after a literal run: 3-byte match with the
        // M2-offset bias
        NEED_IN(1);
        size_t dist = (1 + 0x800) + (t >> 2) + ((size_t)src[ip++] << 2);
        if (dist > op) return UDA_LZO_E_LOOKBEHIND_OVERRUN;
        NEED_OUT(3);
        const uint8_t* m = dst + op - dist;
        for (int i = 0; i < 3; ++i) dst[op++] = m[i];
        state = (int)(t & 3);  // state rides the TOKEN low bits for M1
      } else {
        mode = MATCH;
        continue;
      }
    } else {  // MATCH
      if (t >= 64) {           // M2
        NEED_IN(1);
        size_t dist = 1 + ((t >> 2) & 7) + ((size_t)src[ip++] << 3);
        size_t count = (t >> 5) - 1 + 2;
        if (dist > op) return UDA_LZO_E_LOOKBEHIND_OVERRUN;
        NEED_OUT(count);
        const uint8_t* m = dst + op - dist;
        for (size_t i = 0; i < count; ++i) dst[op++] = m[i];
        state = (int)(t & 3);
      } else if (t >= 32) {    // M3
        size_t count = t & 31;
        if (count == 0) { count = extended(31, &err); if (err) return err; }
        count += 2;
        NEED_IN(2);
        uint8_t d0 = src[ip++], d1 = src[ip++];
        size_t dist = 1 + (d0 >> 2) + ((size_t)d1 << 6);
        if (dist > op) return UDA_LZO_E_LOOKBEHIND_OVERRUN;
        NEED_OUT(count);
        const uint8_t* m = dst + op - dist;
        for (size_t i = 0; i < count; ++i) dst[op++] = m[i];
        state = d0 & 3;
      } else if (t >= 16) {    // M4 or EOS
        size_t hi = (t & 8) << 11;
        size_t count = t & 7;
        if (count == 0) { count = extended(7, &err); if (err) return err; }
        NEED_IN(2);
        uint8_t d0 = src[ip++], d1 = src[ip++];
        size_t dlow = (d0 >> 2) + ((size_t)d1 << 6);
        if (hi == 0 && dlow == 0) {
          if (count != 1) return UDA_LZO_E_EOF_NOT_FOUND;
          break;  // end of stream
        }
        count += 2;
        size_t dist = hi + dlow + 0x4000;
        if (dist > op) return UDA_LZO_E_LOOKBEHIND_OVERRUN;
        NEED_OUT(count);
        const uint8_t* m = dst + op - dist;
        for (size_t i = 0; i < count; ++i) dst[op++] = m[i];
        state = d0 & 3;
      } else {                 // M1: 2-byte match
        NEED_IN(1);
        size_t dist = 1 + (t >> 2) + ((size_t)src[ip++] << 2);
        if (dist > op) return UDA_LZO_E_LOOKBEHIND_OVERRUN;
        NEED_OUT(2);
        const uint8_t* m = dst + op - dist;
        dst[op++] = m[0]; dst[op++] = m[1];
        state = (int)(t & 3);
      }
    }

    // trailing literals per the match's state bits
    if (state == 0) {
      mode = LOOP;
    } else {
      NEED_IN((size_t)state); NEED_OUT((size_t)state);
      std::memcpy(dst + op, src + ip, state); op += state; ip += state;
      NEED_IN(1);
      t = src[ip++];
      mode = MATCH;
    }
  }

  *dst_len = op;
  if (ip != src_len) return UDA_LZO_E_INPUT_NOT_CONSUMED;
  return UDA_LZO_OK;

#undef NEED_IN
#undef NEED_OUT
}

// ---------------------------------------------------------------------------
// compressor: greedy hash-table matcher emitting M2/M3/M4 + literal runs
// ---------------------------------------------------------------------------

static inline uint32_t hash4(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return (v * 0x9E3779B1u) >> 18;  // 14-bit table
}

int uda_lzo1x_1_compress(const uint8_t* src, size_t src_len,
                         uint8_t* dst, size_t* dst_len) {
  const size_t cap = *dst_len;
  size_t op = 0;
  *dst_len = 0;
#define PUT(b) do { if (op >= cap) return UDA_LZO_E_OUTPUT_OVERRUN; \
                    dst[op++] = (uint8_t)(b); } while (0)

  static thread_local int32_t table[1 << 14];
  for (auto& e : table) e = -1;

  size_t pos = 0, lit_start = 0;
  long prev_state_at = -1;  // dst index whose low 2 bits carry the next
                            // run's 1..3 trailing literals (match d0/token)
  bool first_emit = true;

  // flush pending literals [lit_start, pos); returns error or 0
  auto flush_literals = [&]() -> int {
    size_t p = pos - lit_start;
    if (p == 0) return 0;
    if (first_emit) {
      // initial-run form: 17+p for p <= 238, else the extended loop form
      if (p <= 238) {
        PUT(17 + p);
      } else {
        size_t t = p - 3, x = t - 15, zeros = x / 255, fin = x % 255;
        if (fin == 0) { zeros -= 1; fin = 255; }
        PUT(0);
        for (size_t i = 0; i < zeros; ++i) PUT(0);
        PUT(fin);
      }
    } else if (p < 4) {
      // ride the previous match's state bits
      if (prev_state_at < 0) return UDA_LZO_E_OUTPUT_OVERRUN;  // logic bug
      dst[prev_state_at] = (uint8_t)(dst[prev_state_at] | (p & 3));
    } else {
      size_t t = p - 3;
      if (t <= 15) {
        PUT(t);
      } else {
        size_t x = t - 15, zeros = x / 255, fin = x % 255;
        if (fin == 0) { zeros -= 1; fin = 255; }
        PUT(0);
        for (size_t i = 0; i < zeros; ++i) PUT(0);
        PUT(fin);
      }
    }
    if (op + p > cap) return UDA_LZO_E_OUTPUT_OVERRUN;
    std::memcpy(dst + op, src + lit_start, p); op += p;
    lit_start = pos;
    first_emit = false;
    return 0;
  };

  while (pos + 4 <= src_len) {
    uint32_t h = hash4(src + pos);
    int32_t cand = table[h];
    table[h] = (int32_t)pos;
    size_t mlen = 0, dist = 0;
    if (cand >= 0) {
      dist = pos - (size_t)cand;
      if (dist >= 1 && dist <= 0xBFFF &&
          std::memcmp(src + cand, src + pos, 4) == 0) {
        mlen = 4;
        size_t maxl = src_len - pos;
        while (mlen < maxl && mlen < 0x800 &&
               src[cand + mlen] == src[pos + mlen])
          ++mlen;
        // short far matches don't pay for their token
        if (mlen == 4 && dist > 0x4000) mlen = 0;
      }
    }
    if (mlen < 3) {
      ++pos;
      continue;
    }
    int rc = flush_literals();
    if (rc) return rc;
    // emit the match; remember where its state bits live
    if (dist <= 0x800 && mlen <= 8) {                  // M2
      prev_state_at = (long)op;
      PUT(((mlen - 1) << 5) | (((dist - 1) & 7) << 2));
      PUT((dist - 1) >> 3);
    } else if (dist <= 0x4000) {                       // M3
      size_t lt = mlen - 2;
      if (lt <= 31) {
        PUT(32 | lt);
      } else {
        size_t x = lt - 31, zeros = x / 255, fin = x % 255;
        if (fin == 0) { zeros -= 1; fin = 255; }
        PUT(32);
        for (size_t i = 0; i < zeros; ++i) PUT(0);
        PUT(fin);
      }
      size_t D = dist - 1;
      prev_state_at = (long)op;
      PUT((D & 0x3F) << 2);
      PUT(D >> 6);
    } else {                                           // M4
      size_t D = dist - 0x4000;  // 1..0x7FFF
      size_t lt = mlen - 2;
      uint8_t hi = (uint8_t)((D >> 11) & 8);
      if (lt <= 7) {
        PUT(16 | hi | lt);
      } else {
        size_t x = lt - 7, zeros = x / 255, fin = x % 255;
        if (fin == 0) { zeros -= 1; fin = 255; }
        PUT(16 | hi);
        for (size_t i = 0; i < zeros; ++i) PUT(0);
        PUT(fin);
      }
      size_t dlow = D & 0x3FFF;
      prev_state_at = (long)op;
      PUT((dlow & 0x3F) << 2);
      PUT(dlow >> 6);
    }
    first_emit = false;
    // seed the table through the matched span (sparse: every 2nd byte
    // keeps the scan cheap on long matches)
    for (size_t i = 1; i < mlen && pos + i + 4 <= src_len; i += 2)
      table[hash4(src + pos + i)] = (int32_t)(pos + i);
    pos += mlen;
    lit_start = pos;
  }
  pos = src_len;
  int rc = flush_literals();
  if (rc) return rc;
  // EOS
  PUT(0x11); PUT(0x00); PUT(0x00);
  *dst_len = op;
  return UDA_LZO_OK;
#undef PUT
}

}  // extern "C"
