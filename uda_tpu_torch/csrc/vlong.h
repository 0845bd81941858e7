// The port's copy of uda_tpu/native/vlong.h (same C ABI, same bytes).
// Hadoop zero-compressed VLong codec, shared by the native codec
// (codec.cc) and the k-way merge (merge.cc). Byte-exact twin of
// uda_tpu_torch/utils/vint.py, mirroring the reference's
// decodeVIntSize/readVLong/writeVLong semantics (reference
// src/CommUtils/IOUtility.cc:167-397).
#ifndef UDA_TPU_NATIVE_VLONG_H_
#define UDA_TPU_NATIVE_VLONG_H_

#include <cstdint>

namespace uda {

// Decode one VLong at buf[pos]. Returns bytes consumed, 0 on truncation.
inline int decode_vlong(const uint8_t* buf, int64_t len, int64_t pos,
                        int64_t* out) {
  if (pos >= len) return 0;
  int8_t first = static_cast<int8_t>(buf[pos]);
  if (first >= -112) {
    *out = first;
    return 1;
  }
  int size = (first >= -120) ? (-111 - first) : (-119 - first);
  if (pos + size > len) return 0;
  uint64_t v = 0;
  for (int i = 1; i < size; ++i) {
    v = (v << 8) | buf[pos + i];
  }
  *out = (first < -120) ? static_cast<int64_t>(~v) : static_cast<int64_t>(v);
  return size;
}

// Encode one VLong into out (needs up to 9 bytes). Returns bytes written.
inline int encode_vlong(int64_t v, uint8_t* out) {
  if (v >= -112 && v <= 127) {
    out[0] = static_cast<uint8_t>(v);
    return 1;
  }
  int tag = -112;
  uint64_t u = static_cast<uint64_t>(v);
  if (v < 0) {
    u = ~u;
    tag = -120;
  }
  int body = 0;
  for (uint64_t t = u; t; t >>= 8) ++body;
  out[0] = static_cast<uint8_t>(tag - body);
  for (int i = 0; i < body; ++i) {
    out[1 + i] = static_cast<uint8_t>(u >> (8 * (body - 1 - i)));
  }
  return body + 1;
}

}  // namespace uda

#endif  // UDA_TPU_NATIVE_VLONG_H_
