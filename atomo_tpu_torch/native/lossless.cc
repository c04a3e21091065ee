// Host-side lossless byte codec of the port: blosc-style byte shuffle + fast
// LZ, the port's own copy of atomo_tpu/native/lossless.cc. The stream format
// is the same byte for byte, so either package decompresses the other's
// output.
//
// It stands in for the reference's python-blosc usage (src/utils.py:3-16
// wraps blosc.compress(typesize=8, cname='blosclz') around pickled gradient
// messages). The gradient wire moves device tensors inside collectives,
// where a byte-level host codec has no place, so this codec serves the host
// side: checkpoints (training/checkpoint.py, --compress). The design follows
// blosc's recipe -- a byte shuffle (transpose the bytes of fixed-size
// elements so the high bytes of floats group together) followed by a greedy
// hash-chain LZ with a 64 KiB window -- but is an independent implementation.
//
// Build: g++ -O3 -shared -fPIC lossless.cc -o liblossless.so
// (native/lossless.py builds it at first use).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMinMatch = 4;
constexpr int kHashBits = 16;
constexpr uint32_t kMaxOffset = 65535;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashBits);
}

// varint: 7 bits per byte, high bit = continue
inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *p++ = static_cast<uint8_t>(v);
  return p;
}

inline const uint8_t* get_varint(const uint8_t* p, const uint8_t* end, uint64_t* v) {
  uint64_t out = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    out |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = out;
      return p;
    }
    shift += 7;
    if (shift > 63) break;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Worst case is alternating 1-byte literal runs and minimum-length matches:
// every 5 input bytes can cost up to 3 (literal op) + 5 (match op) output
// bytes. 2*n + 64 safely covers that and all varint/header overheads.
int64_t atomo_lz_bound(int64_t n) { return 2 * n + 64; }

// Stream format: repeated ops until raw size reached.
//   op 0x00: literal run  -- varint len, then len raw bytes
//   op 0x01: match        -- varint len (>= kMinMatch), u16le offset
int64_t atomo_lz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n < 0 || cap < atomo_lz_bound(n)) return -1;
  uint32_t table[1 << kHashBits];
  std::memset(table, 0xff, sizeof(table));

  uint8_t* op = dst;
  int64_t pos = 0;
  int64_t lit_start = 0;

  auto flush_literals = [&](int64_t upto) {
    if (upto > lit_start) {
      *op++ = 0x00;
      op = put_varint(op, static_cast<uint64_t>(upto - lit_start));
      std::memcpy(op, src + lit_start, static_cast<size_t>(upto - lit_start));
      op += upto - lit_start;
    }
  };

  uint32_t misses = 0;  // LZ4-style acceleration: skip ahead in barren regions
  while (pos + kMinMatch <= n) {
    uint32_t h = hash4(load32(src + pos));
    uint32_t cand = table[h];
    table[h] = static_cast<uint32_t>(pos);
    if (cand != 0xffffffffu && pos - cand <= kMaxOffset &&
        load32(src + cand) == load32(src + pos)) {
      misses = 0;
      int64_t len = kMinMatch;
      while (pos + len < n && src[cand + len] == src[pos + len]) ++len;
      flush_literals(pos);
      *op++ = 0x01;
      op = put_varint(op, static_cast<uint64_t>(len));
      uint32_t off = static_cast<uint32_t>(pos - cand);
      *op++ = static_cast<uint8_t>(off & 0xff);
      *op++ = static_cast<uint8_t>(off >> 8);
      pos += len;
      lit_start = pos;
    } else {
      pos += 1 + (misses++ >> 6);
    }
  }
  flush_literals(n);
  return op - dst;
}

// Walk the token stream WITHOUT writing output and return the exact decoded
// size, or -1 on any malformed token. Varint match lengths make the format's
// expansion ratio unbounded for legitimate input (a giant zero run compresses
// to a handful of bytes), so a fixed rawlen/payload ratio cap would reject
// valid blobs; instead callers use this O(payload) scan to validate an
// untrusted header's rawlen BEFORE allocating rawlen bytes (a hostile header
// must not make the --compress load path allocate what it claims).
int64_t atomo_lz_scan(const uint8_t* src, int64_t n) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  uint64_t total = 0;
  constexpr uint64_t kMaxTotal = uint64_t(1) << 62;  // overflow guard
  if (n < 0) return -1;
  while (ip < end) {
    uint8_t opcode = *ip++;
    uint64_t len;
    ip = get_varint(ip, end, &len);
    if (!ip) return -1;
    if (len > kMaxTotal - total) return -1;
    if (opcode == 0x00) {
      if (len > static_cast<uint64_t>(end - ip)) return -1;
      ip += len;
    } else if (opcode == 0x01) {
      if (end - ip < 2) return -1;
      uint32_t off = static_cast<uint32_t>(ip[0]) | (static_cast<uint32_t>(ip[1]) << 8);
      ip += 2;
      // a match can never reach before the start of the output
      if (off == 0 || off > total) return -1;
    } else {
      return -1;
    }
    total += len;
  }
  return static_cast<int64_t>(total);
}

int64_t atomo_lz_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  int64_t pos = 0;
  if (n < 0 || cap < 0) return -1;
  while (ip < end) {
    uint8_t opcode = *ip++;
    uint64_t len;
    ip = get_varint(ip, end, &len);
    if (!ip) return -1;
    // `len` is corruption-controlled (any varint up to ~2^64): compare it
    // against the *remaining* unsigned spans before any pointer arithmetic
    // or signed cast -- `ip + len` could overflow the pointer and a
    // len >= 2^63 would go negative through int64_t, bypassing both guards.
    if (len > static_cast<uint64_t>(cap - pos)) return -1;
    if (opcode == 0x00) {
      if (len > static_cast<uint64_t>(end - ip)) return -1;
      std::memcpy(dst + pos, ip, static_cast<size_t>(len));
      ip += len;
      pos += static_cast<int64_t>(len);
    } else if (opcode == 0x01) {
      if (end - ip < 2) return -1;
      uint32_t off = static_cast<uint32_t>(ip[0]) | (static_cast<uint32_t>(ip[1]) << 8);
      ip += 2;
      if (off == 0 || static_cast<int64_t>(off) > pos) return -1;
      // overlapping copy must run forward byte-by-byte
      for (uint64_t i = 0; i < len; ++i) dst[pos + i] = dst[pos + i - off];
      pos += static_cast<int64_t>(len);
    } else {
      return -1;
    }
  }
  return pos;
}

// blosc-style byte shuffle: group byte j of every `typesize`-sized element.
void atomo_shuffle(const uint8_t* src, int64_t n, uint8_t* dst, int32_t typesize) {
  if (typesize <= 1) {
    std::memcpy(dst, src, static_cast<size_t>(n));
    return;
  }
  int64_t nelem = n / typesize;
  int64_t tail = n - nelem * typesize;
  for (int32_t j = 0; j < typesize; ++j)
    for (int64_t k = 0; k < nelem; ++k)
      dst[j * nelem + k] = src[k * typesize + j];
  if (tail) std::memcpy(dst + nelem * typesize, src + nelem * typesize, static_cast<size_t>(tail));
}

void atomo_unshuffle(const uint8_t* src, int64_t n, uint8_t* dst, int32_t typesize) {
  if (typesize <= 1) {
    std::memcpy(dst, src, static_cast<size_t>(n));
    return;
  }
  int64_t nelem = n / typesize;
  int64_t tail = n - nelem * typesize;
  for (int32_t j = 0; j < typesize; ++j)
    for (int64_t k = 0; k < nelem; ++k)
      dst[k * typesize + j] = src[j * nelem + k];
  if (tail) std::memcpy(dst + nelem * typesize, src + nelem * typesize, static_cast<size_t>(tail));
}

}  // extern "C"
