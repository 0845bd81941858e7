// The port's copy of uda_tpu/native/codec.cc (same C ABI, same bytes).
// Native IFile/VInt codec: the host-staging hot path.
//
// C++ equivalent of the reference's StreamUtility VInt/VLong codec and
// record framing walk (reference src/CommUtils/IOUtility.cc:167-397,
// src/Merger/StreamRW.cc:334-449), exposed through a C ABI consumed via
// ctypes (uda_tpu_torch/native/__init__.py). One pass converts an IFile
// segment buffer into columnar (offset, length) arrays — the same
// contract as uda_tpu_torch.utils.ifile.crack/crack_partial, which remain the
// pure-Python reference implementation these functions are parity-tested
// against (tests/test_torch_native.py).

#include <cstdint>
#include <cstddef>
#include <cstring>

#include "vlong.h"

using uda::decode_vlong;

extern "C" {

// Error codes (negative returns)
enum : int64_t {
  UDA_ERR_CORRUPT = -1,     // negative length that isn't the EOF marker
  UDA_ERR_OVERFLOW = -2,    // more records than max_records
};

// Scan consecutive VLongs; returns count decoded (stops at truncation).
int64_t uda_decode_vlongs(const uint8_t* buf, int64_t len, int64_t* out,
                          int64_t max) {
  int64_t pos = 0, n = 0;
  while (pos < len && n < max) {
    int used = decode_vlong(buf, len, pos, &out[n]);
    if (used == 0) break;
    pos += used;
    ++n;
  }
  return n;
}

// One-pass columnar crack of an IFile segment (the native twin of
// ifile.crack_partial). Writes up to max_records (key_off, key_len,
// val_off, val_len) rows. Returns the record count or a UDA_ERR_* code;
// *consumed = bytes consumed (complete records + EOF marker),
// *saw_eof = 1 if the (-1,-1) marker was reached.
int64_t uda_crack(const uint8_t* buf, int64_t len,
                  int64_t* key_off, int64_t* key_len,
                  int64_t* val_off, int64_t* val_len,
                  int64_t max_records, int64_t* consumed, int32_t* saw_eof) {
  int64_t pos = 0, n = 0;
  *saw_eof = 0;
  while (pos < len) {
    int64_t start = pos;
    int64_t klen, vlen;
    int used = decode_vlong(buf, len, pos, &klen);
    if (used == 0) { pos = start; break; }
    int64_t p = pos + used;
    used = decode_vlong(buf, len, p, &vlen);
    if (used == 0) { pos = start; break; }
    p += used;
    if (klen == -1 && vlen == -1) {
      pos = p;
      *saw_eof = 1;
      break;
    }
    if (klen < 0 || vlen < 0) return UDA_ERR_CORRUPT;
    if (p + klen + vlen > len) { pos = start; break; }
    if (n >= max_records) return UDA_ERR_OVERFLOW;
    key_off[n] = p;
    key_len[n] = klen;
    val_off[n] = p + klen;
    val_len[n] = vlen;
    pos = p + klen + vlen;
    ++n;
  }
  *consumed = pos;
  return n;
}

// Serialize records into IFile framing (VInt klen, VInt vlen, key, val).
// Returns bytes written or -1 if out_cap is too small. Appends the EOF
// marker when write_eof != 0.
using uda::encode_vlong;

int64_t uda_write_records(const uint8_t* data,
                          const int64_t* key_off, const int64_t* key_len,
                          const int64_t* val_off, const int64_t* val_len,
                          int64_t n, uint8_t* out, int64_t out_cap,
                          int32_t write_eof) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t need = key_len[i] + val_len[i] + 20;
    if (pos + need > out_cap) return -1;
    pos += encode_vlong(key_len[i], out + pos);
    pos += encode_vlong(val_len[i], out + pos);
    const uint8_t* k = data + key_off[i];
    for (int64_t j = 0; j < key_len[i]; ++j) out[pos + j] = k[j];
    pos += key_len[i];
    const uint8_t* v = data + val_off[i];
    for (int64_t j = 0; j < val_len[i]; ++j) out[pos + j] = v[j];
    pos += val_len[i];
  }
  if (write_eof) {
    if (pos + 2 > out_cap) return -1;
    out[pos++] = 0xFF;
    out[pos++] = 0xFF;
  }
  return pos;
}

}  // extern "C"

// Span gather: dst[dst_off[i] : dst_off[i]+len[i]] = src[src_off[i] : ...]
// for every record i — the byte-movement core of the streaming
// interleave and slab gather (uda_tpu_torch/merger/streaming.py). The numpy
// fallback builds an int64 index per BYTE (8x the memory traffic);
// this is a straight memcpy per record.
extern "C" void uda_gather_spans(const uint8_t* src, const int64_t* src_off,
                                 const int64_t* lens, int64_t n,
                                 uint8_t* dst, const int64_t* dst_off) {
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(dst + dst_off[i], src + src_off[i], (size_t)lens[i]);
}
