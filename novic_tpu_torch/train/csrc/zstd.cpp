// zstd frames (RFC 8878) for the host: a decoder, an encoder of raw-block
// frames, and the CRC-32C and XXH64 checksums the checkpoint formats use.
//
// The decoder takes a user-supplied file, so every read of the input and every
// write of the output is bounds-checked: a truncated or corrupt stream returns
// a negative error code, never reads past its input and never writes past the
// output's capacity. It covers raw, RLE and compressed blocks; raw, RLE,
// Huffman-compressed and treeless literals in 1 or 4 streams; predefined, RLE,
// FSE-compressed and repeated sequence tables; repeat offsets; single-segment
// and windowed frames with or without a content size and a checksum (checked:
// the low 32 bits of XXH64); concatenated frames and skippable frames. Frames
// that need a dictionary are refused.
//
// Plain C interface, bound through ctypes by novic_tpu_torch/train/zstd.py:
//   novic_zstd_decompress(src, n, dst, cap)       bytes written, or < 0
//   novic_zstd_decompress_alloc(src, n, limit, &ptr)  at most `limit` bytes in *ptr
//                                                 (novic_zstd_free), or < 0
//   novic_zstd_content_size(src, n)               declared total, -1 unknown, or < -1
//   novic_zstd_compress_raw(src, n, dst, cap)     raw-block frame, bytes written, or < 0
//   novic_zstd_raw_bound(n), novic_crc32c(crc, p, n)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

enum : int64_t {
  kCorrupt = -2,
  kDstTooSmall = -3,
  kTruncated = -4,
  kChecksum = -5,
  kDictionary = -6,
  kNoMemory = -7,
  kSizeMismatch = -8,
};

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }

constexpr size_t kBlockMax = 128 * 1024;

inline int highbit(uint64_t x) { return 63 - __builtin_clzll(x); }

// memcpy/memset that take a null pointer with a size of 0 (an empty output)
inline void copy(uint8_t* d, const uint8_t* s, size_t n) {
  if (n) std::memcpy(d, s, n);
}
inline void fill(uint8_t* d, uint8_t v, size_t n) {
  if (n) std::memset(d, v, n);
}

inline uint64_t load_le(const uint8_t* p, size_t k) {
  uint64_t v = 0;
  for (size_t i = 0; i < k; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// Checksums
// ---------------------------------------------------------------------------

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;
    crc = kCrc.t[7][w & 0xFF] ^ kCrc.t[6][(w >> 8) & 0xFF] ^ kCrc.t[5][(w >> 16) & 0xFF] ^
          kCrc.t[4][(w >> 24) & 0xFF] ^ kCrc.t[3][(w >> 32) & 0xFF] ^
          kCrc.t[2][(w >> 40) & 0xFF] ^ kCrc.t[1][(w >> 48) & 0xFF] ^ kCrc.t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xxh_round(v1, load_le(p, 8));
      v2 = xxh_round(v2, load_le(p + 8, 8));
      v3 = xxh_round(v3, load_le(p + 16, 8));
      v4 = xxh_round(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (end - p >= 8) {
    h = rotl(h ^ xxh_round(0, load_le(p, 8)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (*p++ * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Input and output
// ---------------------------------------------------------------------------

struct In {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  const uint8_t* take(size_t k) {
    if (k > n - pos) fail(kTruncated);
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
  uint64_t le(size_t k) { return load_le(take(k), k); }
};

// A fixed buffer (the caller's), or one that grows (malloc/realloc) up to `limit`
struct Out {
  uint8_t* p;
  size_t cap;
  size_t len = 0;
  bool grows;
  size_t limit = 0;
  void need(size_t k) {
    if (k <= cap - len) return;
    if (!grows || k > limit - len) fail(kDstTooSmall);
    size_t want = cap * 2 > len + k ? cap * 2 : len + k;
    if (want > limit) want = limit;
    if (want < 65536) want = 65536;
    void* q = std::realloc(p, want);
    if (!q) fail(kNoMemory);
    p = static_cast<uint8_t*>(q);
    cap = want;
  }
};

// Forward little-endian bit reader over [p, p + n) (FSE table descriptions)
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++bit) {
      if ((bit >> 3) >= n) fail(kCorrupt);
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes() const { return (bit + 7) >> 3; }
};

// Backward bit reader (Huffman and FSE streams). The last byte's highest set
// bit marks the end; bits before the start of the stream read as zeros, and the
// callers check where the position ends.
struct BwdBits {
  const uint8_t* p;
  size_t n;
  int64_t off;
  BwdBits(const uint8_t* src, size_t len) : p(src), n(len) {
    if (len == 0 || src[len - 1] == 0) fail(kCorrupt);
    off = int64_t(len) * 8 - 8 + highbit(src[len - 1]);
  }
  uint64_t word(size_t b) const {
    if (b + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, p + b, 8);
      return w;
    }
    return load_le(p + b, n - b);
  }
  // k <= 56
  uint64_t read(int k) {
    if (k == 0) return 0;
    int64_t o = off - k;
    off = o;
    if (o >= 0) return (word(size_t(o) >> 3) >> (o & 7)) & ((uint64_t(1) << k) - 1);
    int64_t hi = o + k;
    if (hi <= 0) return 0;
    return (word(0) & ((uint64_t(1) << hi) - 1)) << (-o);
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

constexpr int kMaxFseLog = 9;

struct Fse {
  int log = -1;  // -1: no table yet
  uint8_t sym[1 << kMaxFseLog];
  uint8_t bits[1 << kMaxFseLog];
  uint16_t base[1 << kMaxFseLog];

  void build(const int16_t* norm, int nsym, int accuracy) {
    const int size = 1 << accuracy;
    uint16_t next[256];
    int high = size - 1;
    for (int s = 0; s < nsym; ++s)
      if (norm[s] == -1) {
        sym[high--] = uint8_t(s);
        next[s] = 1;
      }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = uint16_t(norm[s]);
      for (int i = 0; i < norm[s]; ++i) {
        sym[pos] = uint8_t(s);
        do pos = (pos + step) & mask;
        while (pos > high);
      }
    }
    if (pos != 0) fail(kCorrupt);
    for (int i = 0; i < size; ++i) {
      uint16_t d = next[sym[i]]++;
      bits[i] = uint8_t(accuracy - highbit(d));
      base[i] = uint16_t((d << bits[i]) - size);
    }
    log = accuracy;
  }

  void rle(uint8_t s) {
    sym[0] = s;
    bits[0] = 0;
    base[0] = 0;
    log = 0;
  }

  // A table description read forward from `in`; returns its size in bytes
  size_t read(const uint8_t* p, size_t n, int max_log, int max_sym) {
    FwdBits b{p, n};
    const int accuracy = 5 + int(b.read(4));
    if (accuracy > max_log) fail(kCorrupt);
    int remaining = 1 << accuracy;
    int16_t norm[256];
    int s = 0;
    while (remaining > 0) {
      if (s > max_sym) fail(kCorrupt);
      const int k = highbit(uint64_t(remaining) + 1) + 1;
      uint32_t v = b.read(k);
      const uint32_t low = (1u << (k - 1)) - 1;
      const uint32_t threshold = (1u << k) - 1 - uint32_t(remaining + 1);
      if ((v & low) < threshold) {
        b.bit -= 1;
        v &= low;
      } else if (v > low) {
        v -= threshold;
      }
      const int prob = int(v) - 1;
      remaining -= prob < 0 ? -prob : prob;
      norm[s++] = int16_t(prob);
      if (prob == 0) {
        for (;;) {
          const uint32_t rep = b.read(2);
          for (uint32_t i = 0; i < rep; ++i) {
            if (s > max_sym) fail(kCorrupt);
            norm[s++] = 0;
          }
          if (rep != 3) break;
        }
      }
    }
    if (remaining != 0 || s > max_sym + 1) fail(kCorrupt);
    build(norm, s, accuracy);
    return b.bytes();
  }

  uint32_t init(BwdBits& b) const { return uint32_t(b.read(log)); }
  uint32_t update(uint32_t state, BwdBits& b) const {
    return base[state] + uint32_t(b.read(bits[state]));
  }
};

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

constexpr int kMaxHufBits = 11;

struct Huf {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << kMaxHufBits];
  uint8_t nbits[1 << kMaxHufBits];

  void from_weights(const uint8_t* w, int n) {
    uint64_t total = 0;
    for (int i = 0; i < n; ++i) {
      if (w[i] > kMaxHufBits) fail(kCorrupt);
      if (w[i]) total += uint64_t(1) << (w[i] - 1);
    }
    if (total == 0) fail(kCorrupt);
    const int mb = highbit(total) + 1;
    if (mb > kMaxHufBits) fail(kCorrupt);
    const uint64_t rest = (uint64_t(1) << mb) - total;
    if (rest & (rest - 1)) fail(kCorrupt);
    if (n + 1 > 256) fail(kCorrupt);
    uint8_t b[256];
    for (int i = 0; i < n; ++i) b[i] = w[i] ? uint8_t(mb + 1 - w[i]) : 0;
    b[n] = uint8_t(mb + 1 - (highbit(rest) + 1));
    const int count = n + 1;
    uint32_t rank_count[kMaxHufBits + 2] = {0};
    for (int i = 0; i < count; ++i) rank_count[b[i]]++;
    uint32_t rank_idx[kMaxHufBits + 2];
    rank_idx[mb] = 0;
    for (int i = mb; i >= 1; --i) {
      rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (mb - i));
      if (rank_idx[i - 1] > (1u << mb)) fail(kCorrupt);
      std::memset(nbits + rank_idx[i], i, rank_idx[i - 1] - rank_idx[i]);
    }
    if (rank_idx[0] != (1u << mb)) fail(kCorrupt);
    for (int i = 0; i < count; ++i) {
      if (!b[i]) continue;
      const uint32_t code = rank_idx[b[i]], len = 1u << (mb - b[i]);
      std::memset(sym + code, i, len);
      rank_idx[b[i]] += len;
    }
    max_bits = mb;
  }

  // The tree description at p; returns its size in bytes
  size_t read(const uint8_t* p, size_t n) {
    if (n < 1) fail(kCorrupt);
    const int header = p[0];
    uint8_t w[256];
    int count;
    size_t used;
    if (header >= 128) {
      count = header - 127;
      used = 1 + size_t(count + 1) / 2;
      if (used > n) fail(kCorrupt);
      for (int i = 0; i < count; ++i) {
        const uint8_t byte = p[1 + i / 2];
        w[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 15);
      }
    } else {
      used = 1 + size_t(header);
      if (used > n || header == 0) fail(kCorrupt);
      Fse t;
      const size_t desc = t.read(p + 1, size_t(header), 6, 11);
      if (desc >= size_t(header)) fail(kCorrupt);
      BwdBits b(p + 1 + desc, size_t(header) - desc);
      uint32_t s1 = t.init(b), s2 = t.init(b);
      count = 0;
      for (;;) {
        if (count > 253) fail(kCorrupt);
        w[count++] = t.sym[s1];
        s1 = t.update(s1, b);
        if (b.off < 0) {
          w[count++] = t.sym[s2];
          break;
        }
        w[count++] = t.sym[s2];
        s2 = t.update(s2, b);
        if (b.off < 0) {
          w[count++] = t.sym[s1];
          break;
        }
      }
    }
    from_weights(w, count);
    return used;
  }

  // A Huffman stream being decoded: `count` symbols into `out`. The decoding
  // state is the next max_bits bits below the stream position `off` (zeros
  // below the stream's start); a symbol consumes its code's bits.
  struct Cursor {
    BwdBits b;
    int64_t off;
    uint8_t* out;
    size_t count;
    size_t i = 0;
    Cursor(const uint8_t* src, size_t n, uint8_t* o, size_t c) : b(src, n), off(b.off), out(o), count(c) {}
    // While 64 bits remain, one 8-byte load serves four symbols (at most 44
    // bits of codes and an 11-bit peek past them)
    bool fast() const { return i + 4 <= count && off >= 64; }
  };

  void four(Cursor& c) const {
    const size_t hi = size_t(c.off + 7) >> 3;  // 8 <= hi <= n
    uint64_t w;
    std::memcpy(&w, c.b.p + hi - 8, 8);
    uint64_t v = w << (64 - (c.off - int64_t(hi - 8) * 8));  // stream bit off - 1 at bit 63
    for (int k = 0; k < 4; ++k) {
      const uint32_t idx = uint32_t(v >> (64 - max_bits));
      c.out[c.i++] = sym[idx];
      v <<= nbits[idx];
      c.off -= nbits[idx];
    }
  }

  void finish(Cursor& c) const {
    while (c.fast()) four(c);
    const int mb = max_bits;
    for (; c.i < c.count; ++c.i) {
      if (c.off <= 0) fail(kCorrupt);
      uint32_t idx;
      if (c.off >= mb) {
        const int64_t lo = c.off - mb;
        idx = uint32_t((c.b.word(size_t(lo) >> 3) >> (lo & 7)) & ((1u << mb) - 1));
      } else {
        idx = uint32_t((c.b.word(0) & ((uint64_t(1) << c.off) - 1)) << (mb - c.off));
      }
      c.out[c.i] = sym[idx];
      c.off -= nbits[idx];
    }
    if (c.off != 0) fail(kCorrupt);
  }

  void stream(const uint8_t* src, size_t n, uint8_t* out, size_t count) const {
    Cursor c(src, n, out, count);
    finish(c);
  }

  // Four streams in turns, so that their independent decodes overlap
  void streams4(Cursor* c) const {
    while (c[0].fast() && c[1].fast() && c[2].fast() && c[3].fast()) {
      four(c[0]);
      four(c[1]);
      four(c[2]);
      four(c[3]);
    }
    for (int j = 0; j < 4; ++j) finish(c[j]);
  }
};

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
constexpr int kMaxLL = 35, kMaxML = 52, kMaxOF = 31;

struct Frame {
  Fse ll, of, ml;
  Huf huf;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t lit[kBlockMax + 8];
};

// One table of the sequences section per its mode; returns the bytes it used
size_t sequence_table(Fse& t, int mode, const uint8_t* p, size_t n, const int16_t* norm,
                      int nnorm, int norm_log, int max_log, int max_sym) {
  switch (mode) {
    case 0:
      t.build(norm, nnorm, norm_log);
      return 0;
    case 1:
      if (n < 1 || p[0] > max_sym) fail(kCorrupt);
      t.rle(p[0]);
      return 1;
    case 2:
      return t.read(p, n, max_log, max_sym);
    default:
      if (t.log < 0) fail(kCorrupt);
      return 0;
  }
}

void block_compressed(Frame& f, const uint8_t* p, size_t n, Out& out, size_t frame_start) {
  // Literals section
  if (n < 1) fail(kCorrupt);
  const int ltype = p[0] & 3, lfmt = (p[0] >> 2) & 3;
  size_t regen, hsize, csize = 0;
  if (ltype <= 1) {
    if ((lfmt & 1) == 0) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (lfmt == 1) {
      hsize = 2;
      if (n < 2) fail(kCorrupt);
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) fail(kCorrupt);
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
  } else {
    hsize = lfmt <= 1 ? 3 : lfmt == 2 ? 4 : 5;
    if (n < hsize) fail(kCorrupt);
    const uint64_t h = load_le(p, hsize);
    if (hsize == 3) {
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (hsize == 4) {
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
    } else {
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
    }
  }
  if (regen > kBlockMax) fail(kCorrupt);
  size_t pos = hsize;
  const uint8_t* lits = f.lit;
  if (ltype == 0) {
    if (regen > n - pos) fail(kCorrupt);
    lits = p + pos;
    pos += regen;
  } else if (ltype == 1) {
    if (pos >= n) fail(kCorrupt);
    fill(f.lit, p[pos], regen);
    pos += 1;
  } else {
    if (csize > n - pos) fail(kCorrupt);
    const uint8_t* c = p + pos;
    size_t cn = csize;
    if (ltype == 2) {
      const size_t used = f.huf.read(c, cn);
      c += used;
      cn -= used;
    } else if (f.huf.max_bits == 0) {
      fail(kCorrupt);
    }
    if (lfmt == 0) {
      f.huf.stream(c, cn, f.lit, regen);
    } else {
      if (cn < 6) fail(kCorrupt);
      const size_t s1 = load_le(c, 2), s2 = load_le(c + 2, 2), s3 = load_le(c + 4, 2);
      if (s1 + s2 + s3 > cn - 6) fail(kCorrupt);
      const size_t s4 = cn - 6 - s1 - s2 - s3;
      const size_t part = (regen + 3) / 4;
      if (3 * part > regen) fail(kCorrupt);
      const uint8_t* q = c + 6;
      Huf::Cursor cur[4] = {{q, s1, f.lit, part},
                            {q + s1, s2, f.lit + part, part},
                            {q + s1 + s2, s3, f.lit + 2 * part, part},
                            {q + s1 + s2 + s3, s4, f.lit + 3 * part, regen - 3 * part}};
      f.huf.streams4(cur);
    }
    pos += csize;
  }

  // Sequences section
  if (pos >= n) fail(kCorrupt);
  size_t nseq = p[pos++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (pos >= n) fail(kCorrupt);
      nseq = ((nseq - 128) << 8) + p[pos++];
    } else {
      if (n - pos < 2) fail(kCorrupt);
      nseq = p[pos] + (size_t(p[pos + 1]) << 8) + 0x7F00;
      pos += 2;
    }
  }
  size_t lit_used = 0;
  const size_t block_start = out.len;
  if (nseq > 0) {
    if (pos >= n) fail(kCorrupt);
    const int modes = p[pos++];
    if (modes & 3) fail(kCorrupt);
    pos += sequence_table(f.ll, modes >> 6, p + pos, n - pos, kLLNorm, 36, 6, 9, kMaxLL);
    pos += sequence_table(f.of, (modes >> 4) & 3, p + pos, n - pos, kOFNorm, 29, 5, 8, kMaxOF);
    pos += sequence_table(f.ml, (modes >> 2) & 3, p + pos, n - pos, kMLNorm, 53, 6, 9, kMaxML);
    if (pos >= n) fail(kCorrupt);
    BwdBits b(p + pos, n - pos);
    uint32_t sll = f.ll.init(b), sof = f.of.init(b), sml = f.ml.init(b);
    for (size_t i = 0; i < nseq; ++i) {
      const int ofc = f.of.sym[sof], llc = f.ll.sym[sll], mlc = f.ml.sym[sml];
      if (ofc > kMaxOF || llc > kMaxLL || mlc > kMaxML) fail(kCorrupt);
      const uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
      const size_t ml = kMLBase[mlc] + size_t(b.read(kMLBits[mlc]));
      const size_t ll = kLLBase[llc] + size_t(b.read(kLLBits[llc]));
      if (i + 1 < nseq) {
        sll = f.ll.update(sll, b);
        sml = f.ml.update(sml, b);
        sof = f.of.update(sof, b);
      }
      if (b.off < 0) fail(kCorrupt);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        const unsigned idx = unsigned(ofv - 1) + (ll == 0);
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = offset;
        }
      }
      if (ll > regen - lit_used) fail(kCorrupt);
      if (out.len - block_start + ll + ml > kBlockMax) fail(kCorrupt);
      out.need(ll + ml);
      copy(out.p + out.len, lits + lit_used, ll);
      out.len += ll;
      lit_used += ll;
      if (offset == 0 || offset > out.len - frame_start) fail(kCorrupt);
      uint8_t* d = out.p + out.len;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.len += ml;
    }
    if (b.off != 0) fail(kCorrupt);
  } else if (pos != n) {
    fail(kCorrupt);
  }
  const size_t rest = regen - lit_used;
  if (out.len - block_start + rest > kBlockMax) fail(kCorrupt);
  out.need(rest);
  copy(out.p + out.len, lits + lit_used, rest);
  out.len += rest;
}

struct Header {
  uint64_t content_size;  // UINT64_MAX: not declared
  bool checksum;
};

Header frame_header(In& in) {
  const uint8_t fhd = in.take(1)[0];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  const bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail(kCorrupt);  // reserved bit
  if (!single) in.take(1);      // window descriptor: the whole output is kept
  const size_t dict_bytes[4] = {0, 1, 2, 4};
  if (dict_flag && in.le(dict_bytes[dict_flag]) != 0) fail(kDictionary);
  Header h{UINT64_MAX, bool((fhd >> 2) & 1)};
  const size_t fcs_bytes[4] = {size_t(single ? 1 : 0), 2, 4, 8};
  if (fcs_bytes[fcs_flag]) {
    h.content_size = in.le(fcs_bytes[fcs_flag]);
    if (fcs_flag == 1) h.content_size += 256;
  }
  return h;
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail(kTruncated);
  In in{src, n};
  Frame* f = new Frame;  // ~130 KiB of literals and tables
  struct Guard {
    Frame* f;
    ~Guard() { delete f; }
  } guard{f};
  while (in.pos < n) {
    const uint32_t magic = uint32_t(in.le(4));
    if (skippable(magic)) {
      in.take(size_t(in.le(4)));
      continue;
    }
    if (magic != kMagic) fail(kCorrupt);
    const Header h = frame_header(in);
    const size_t start = out.len;
    f->ll.log = f->of.log = f->ml.log = -1;
    f->huf.max_bits = 0;
    f->rep[0] = 1;
    f->rep[1] = 4;
    f->rep[2] = 8;
    if (h.content_size != UINT64_MAX && out.grows && h.content_size <= out.limit - out.len)
      out.need(size_t(h.content_size));
    for (bool last = false; !last;) {
      const uint32_t bh = uint32_t(in.le(3));
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3 || size > kBlockMax) fail(kCorrupt);
      if (type == 0) {
        const uint8_t* p = in.take(size);
        out.need(size);
        copy(out.p + out.len, p, size);
        out.len += size;
      } else if (type == 1) {
        const uint8_t byte = in.take(1)[0];
        out.need(size);
        fill(out.p + out.len, byte, size);
        out.len += size;
      } else {
        block_compressed(*f, in.take(size), size, out, start);
      }
      if (h.content_size != UINT64_MAX && out.len - start > h.content_size) fail(kSizeMismatch);
    }
    if (h.content_size != UINT64_MAX && out.len - start != h.content_size) fail(kSizeMismatch);
    if (h.checksum) {
      const uint32_t want = uint32_t(in.le(4));
      if (uint32_t(xxh64(out.p + start, out.len - start, 0)) != want) fail(kChecksum);
    }
  }
}

int64_t content_size(const uint8_t* src, size_t n) {
  if (n == 0) fail(kTruncated);
  In in{src, n};
  uint64_t total = 0;
  bool known = true;
  while (in.pos < n) {
    const uint32_t magic = uint32_t(in.le(4));
    if (skippable(magic)) {
      in.take(size_t(in.le(4)));
      continue;
    }
    if (magic != kMagic) fail(kCorrupt);
    const Header h = frame_header(in);
    if (h.content_size == UINT64_MAX) known = false;
    else total += h.content_size;
    for (bool last = false; !last;) {
      const uint32_t bh = uint32_t(in.le(3));
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      if (type == 3) fail(kCorrupt);
      in.take(type == 1 ? 1 : size_t(bh >> 3));
    }
    if (h.checksum) in.take(4);
  }
  if (!known) return -1;
  if (total > (uint64_t(1) << 62)) fail(kCorrupt);
  return int64_t(total);
}

template <class F>
int64_t guarded(F&& fn) {
  try {
    return fn();
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace

extern "C" {

int64_t novic_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  return guarded([&]() -> int64_t {
    Out out{dst, cap, 0, false};
    decode_all(src, n, out);
    return int64_t(out.len);
  });
}

int64_t novic_zstd_decompress_alloc(const uint8_t* src, size_t n, size_t limit,
                                    uint8_t** result) {
  *result = nullptr;
  Out out{nullptr, 0, 0, true, limit};
  const int64_t r = guarded([&]() -> int64_t {
    decode_all(src, n, out);
    return int64_t(out.len);
  });
  if (r < 0) {
    std::free(out.p);
    return r;
  }
  *result = out.p;
  return r;
}

void novic_zstd_free(uint8_t* p) { std::free(p); }

int64_t novic_zstd_content_size(const uint8_t* src, size_t n) {
  return guarded([&]() -> int64_t { return content_size(src, n); });
}

size_t novic_zstd_raw_bound(size_t n) { return n + 14 + 3 * (n / kBlockMax + 1); }

// One frame of raw blocks (<= 128 KiB each) with the content size in its header:
// single-segment up to 128 KiB, else a 128 KiB window.
int64_t novic_zstd_compress_raw(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  if (cap < novic_zstd_raw_bound(n)) return kDstTooSmall;
  uint8_t* d = dst;
  const uint32_t magic = kMagic;
  std::memcpy(d, &magic, 4);
  d += 4;
  int fcs_flag;
  size_t fcs_bytes;
  uint64_t fcs = n;
  if (n < 256) {
    fcs_flag = 0;
    fcs_bytes = 1;
  } else if (n < 65536 + 256) {
    fcs_flag = 1;
    fcs_bytes = 2;
    fcs -= 256;
  } else if (n <= 0xFFFFFFFFull) {
    fcs_flag = 2;
    fcs_bytes = 4;
  } else {
    fcs_flag = 3;
    fcs_bytes = 8;
  }
  const bool single = n <= kBlockMax;
  *d++ = uint8_t((fcs_flag << 6) | (single ? 0x20 : 0));
  if (!single) *d++ = uint8_t((17 - 10) << 3);  // window 2^17 = one block
  for (size_t i = 0; i < fcs_bytes; ++i) *d++ = uint8_t(fcs >> (8 * i));
  size_t pos = 0;
  do {
    const size_t size = n - pos < kBlockMax ? n - pos : kBlockMax;
    const bool last = pos + size == n;
    const uint32_t bh = uint32_t(last) | (uint32_t(size) << 3);  // type 0: raw
    d[0] = uint8_t(bh);
    d[1] = uint8_t(bh >> 8);
    d[2] = uint8_t(bh >> 16);
    copy(d + 3, src + pos, size);
    d += 3 + size;
    pos += size;
  } while (pos < n);
  return int64_t(d - dst);
}

uint32_t novic_crc32c(uint32_t crc, const uint8_t* p, size_t n) { return crc32c(crc, p, n); }

}  // extern "C"
