// A Zstandard decoder (RFC 8878) for the port's orbax reader
// (utils/orbax_io.py through utils/zstd.py): the B-tree nodes and the zarr
// chunks of an OCDBT checkpoint are zstd frames.
//
// Written from the RFC. It decodes:
//  * frames (section 3.1.1): single-segment and windowed headers, with or
//    without the content size, dictionary id 0 only, the XXH64 content
//    checksum; concatenated frames and skippable frames (3.1.2);
//  * blocks (3.1.1.2): raw, RLE and compressed, up to 128 KiB;
//  * literals (3.1.1.3.1): raw, RLE, Huffman-coded with direct or
//    FSE-coded weights (4.2.1) in 1 or 4 streams, and treeless literals
//    that reuse the previous Huffman table;
//  * sequences (3.1.1.3.2): predefined, RLE, FSE-coded (4.1) and repeat
//    tables, the three repeat offsets (3.1.2.5), matches that reach back
//    into earlier blocks of the frame.
//
// Nothing here falls back or returns part of an output: every
// inconsistency (truncation, a bad table, a stream not consumed to its
// end, output past the given size, a checksum mismatch) fails the call
// with a message. The output size is the caller's: utils/zstd.py takes it
// from the frame headers (ctpn_zstd_content_size) or from the zarr chunk.
//
// ABI (ctypes, utils/zstd.py):
//   int64_t ctpn_zstd_content_size(src, n, err, errlen)
//       sum of the frames' content sizes; -1 when a frame has none;
//       -2 on a malformed frame (err filled)
//   int64_t ctpn_zstd_decompress(src, n, dst, cap, modes, err, errlen)
//       bytes written, or -1 with err filled; modes[i] += times mode i met
//   int ctpn_zstd_nmodes(); const char* ctpn_zstd_mode_name(int)

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Mode {
  FRAME_SINGLE_SEGMENT,
  FRAME_WINDOWED,
  FRAME_NO_CONTENT_SIZE,
  FRAME_CHECKSUM,
  FRAME_SKIPPABLE,
  BLOCK_RAW,
  BLOCK_RLE,
  BLOCK_COMPRESSED,
  LIT_RAW,
  LIT_RLE,
  LIT_HUFFMAN,
  LIT_TREELESS,
  LIT_1_STREAM,
  LIT_4_STREAMS,
  HUF_WEIGHTS_DIRECT,
  HUF_WEIGHTS_FSE,
  SEQ_NONE,
  SEQ_PREDEFINED,
  SEQ_RLE,
  SEQ_FSE,
  SEQ_REPEAT,
  OFFSET_NEW,
  OFFSET_REPEAT_1,
  OFFSET_REPEAT_2,
  OFFSET_REPEAT_3,
  OFFSET_REPEAT_1_MINUS_1,
  MATCH_ACROSS_BLOCKS,
  N_MODES
};

const char* const kModeNames[N_MODES] = {
    "frame_single_segment", "frame_windowed", "frame_no_content_size",
    "frame_checksum", "frame_skippable", "block_raw", "block_rle",
    "block_compressed", "lit_raw", "lit_rle", "lit_huffman", "lit_treeless",
    "lit_1_stream", "lit_4_streams", "huf_weights_direct", "huf_weights_fse",
    "seq_none", "seq_predefined", "seq_rle", "seq_fse", "seq_repeat",
    "offset_new", "offset_repeat_1", "offset_repeat_2", "offset_repeat_3",
    "offset_repeat_1_minus_1", "match_across_blocks",
};

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kZstdMagic = 0xFD2FB528u;

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

inline uint64_t le_n(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---- XXH64 (the content checksum, RFC 8878 3.1.1) ------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit readers -----------------------------------------------------------

// Backward bitstream (4.1, 4.2.2): the last byte's highest set bit marks the
// end; bits are then read from the most significant end towards byte 0.
// Reads below bit 0 give zeros and leave `pos` negative, which the callers
// treat as an overrun.
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;  // bits not yet read

  BackBits(const uint8_t* src, size_t size, const char* what) : p(src), n(size) {
    if (size == 0) fail("%s: empty bitstream", what);
    uint8_t last = src[size - 1];
    if (last == 0) fail("%s: bitstream has no end mark", what);
    pos = int64_t(size - 1) * 8 + highbit(last);
  }
  // bits [start, start + nb) as an integer, zeros below bit 0; nb <= 56
  uint64_t get(int64_t start, int nb) const {
    if (nb == 0) return 0;
    if (start < 0) {
      int64_t hi = start + nb;
      return hi <= 0 ? 0 : get(0, int(hi)) << (-start);
    }
    int64_t byte = start >> 3;
    uint64_t w = 0;
    if (byte + 8 <= n) {
      memcpy(&w, p + byte, 8);
    } else {
      for (int i = 0; i < 8 && byte + i < n; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (w >> (start & 7)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t read(int nb) {
    pos -= nb;
    return get(pos, nb);
  }
  uint64_t peek(int nb) const { return get(pos - nb, nb); }
};

// ---- FSE tables (4.1) ------------------------------------------------------

struct FseEntry {
  uint16_t sym;
  uint8_t nb;
  uint32_t base;
};

struct Fse {
  int al = 0;
  std::vector<FseEntry> t;
};

Fse fse_build(const int16_t* prob, int nsym, int al) {
  const int size = 1 << al;
  Fse f;
  f.al = al;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (prob[s] == -1) {
      if (high < 0) fail("FSE table: too many less-than-one probabilities");
      f.t[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(prob[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < prob[s]; ++i) {
      f.t[pos].sym = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: probabilities do not fill the table");
  for (int u = 0; u < size; ++u) {
    uint32_t ns = next[f.t[u].sym]++;
    if (ns == 0) fail("FSE table: symbol state overflow");
    int nb = al - highbit(ns);
    f.t[u].nb = uint8_t(nb);
    f.t[u].base = (ns << nb) - uint32_t(size);
  }
  return f;
}

Fse fse_rle(int sym) {
  Fse f;
  f.al = 0;
  f.t.assign(1, FseEntry{uint16_t(sym), 0, 0});
  return f;
}

// FSE table description (4.1.1), a forward little-endian bitstream; returns
// the bytes it takes.
size_t fse_read(const uint8_t* src, size_t n, int max_al, int max_sym, Fse& out,
                const char* what) {
  size_t bit = 0;
  auto peek = [&](int nb) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = bit + i;
      if ((b >> 3) < n && ((src[b >> 3] >> (b & 7)) & 1)) v |= 1u << i;
    }
    return v;
  };
  if (n == 0) fail("%s: missing FSE table description", what);
  int al = int(peek(4)) + 5;
  bit += 4;
  if (al > max_al) fail("%s: FSE accuracy log %d above %d", what, al, max_al);
  std::vector<int16_t> prob(max_sym + 1, 0);
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = peek(2);
        bit += 2;
        n0 += int(r);
        if (r != 3) break;
        if (n0 > max_sym + 1) break;
      }
      if (n0 > max_sym) fail("%s: FSE zero run past symbol %d", what, max_sym);
      while (sym < n0) prob[sym++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    uint32_t v = peek(nbits);
    int count;
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      bit += nbits - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    prob[sym++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < 1) fail("%s: FSE probabilities overflow the table", what);
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("%s: FSE probabilities do not sum to the table", what);
  size_t used = (bit + 7) >> 3;
  if (used > n) fail("%s: truncated FSE table description", what);
  out = fse_build(prob.data(), sym, al);
  return used;
}

// ---- Huffman literals (4.2) -----------------------------------------------

struct Huffman {
  int maxbits = 0;
  std::vector<uint8_t> sym, nb;
  bool valid = false;
};

// Huffman tree description (4.2.1); returns the bytes it takes.
size_t huf_read(const uint8_t* src, size_t n, Huffman& h, int64_t* modes) {
  if (n == 0) fail("literals: missing Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const int header = src[0];
  if (header >= 128) {
    nw = header - 127;
    size_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) fail("literals: truncated Huffman weights");
    for (int i = 0; i < nw; ++i)
      w[i] = (i % 2 == 0) ? (src[1 + i / 2] >> 4) : (src[1 + i / 2] & 15);
    used = 1 + bytes;
    ++modes[HUF_WEIGHTS_DIRECT];
  } else {
    size_t csize = header;
    if (1 + csize > n) fail("literals: truncated FSE-coded Huffman weights");
    Fse f;
    size_t k = fse_read(src + 1, csize, 6, 15, f, "Huffman weights");
    if (k >= csize) fail("Huffman weights: no bitstream after the FSE table");
    BackBits br(src + 1 + k, csize - k, "Huffman weights");
    uint32_t s1 = uint32_t(br.read(f.al)), s2 = uint32_t(br.read(f.al));
    // two interleaved states; stops once a state update reads past the
    // start of the stream, emitting the other state's symbol last
    for (;;) {
      if (nw >= 255) fail("Huffman weights: more than 255 weights");
      w[nw++] = uint8_t(f.t[s1].sym);
      s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].nb));
      if (br.pos < 0) {
        w[nw++] = uint8_t(f.t[s2].sym);
        break;
      }
      if (nw >= 255) fail("Huffman weights: more than 255 weights");
      w[nw++] = uint8_t(f.t[s2].sym);
      s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].nb));
      if (br.pos < 0) {
        w[nw++] = uint8_t(f.t[s1].sym);
        break;
      }
    }
    if (nw > 255) fail("Huffman weights: more than 255 weights");
    used = 1 + csize;
    ++modes[HUF_WEIGHTS_FSE];
  }
  uint64_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman weights: weight %d above 11", w[i]);
    if (w[i]) sum += uint64_t(1) << (w[i] - 1);
  }
  if (sum == 0) fail("Huffman weights: all zero");
  const int maxbits = highbit(sum) + 1;
  if (maxbits > 11) fail("Huffman weights: code length %d above 11", maxbits);
  uint64_t left = (uint64_t(1) << maxbits) - sum;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights: tree is not complete");
  w[nw++] = uint8_t(highbit(left) + 1);
  h.maxbits = maxbits;
  h.sym.assign(size_t(1) << maxbits, 0);
  h.nb.assign(size_t(1) << maxbits, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      size_t len = size_t(1) << (wt - 1);
      for (size_t i = 0; i < len; ++i) {
        h.sym[pos + i] = uint8_t(s);
        h.nb[pos + i] = uint8_t(maxbits + 1 - wt);
      }
      pos += len;
    }
  }
  if (pos != (size_t(1) << maxbits)) fail("Huffman weights: table not filled");
  h.valid = true;
  return used;
}

void huf_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out,
                size_t count) {
  BackBits br(src, n, "Huffman stream");
  const int mb = h.maxbits;
  const uint32_t mask = (1u << mb) - 1;
  const uint8_t *sym = h.sym.data(), *nb = h.nb.data();
  size_t i = 0;
  // fast path: a 64-bit window of the 8 bytes ending at the read position
  // serves symbols until fewer than maxbits bits are left in it
  while (i < count && br.pos >= 64) {
    const int64_t b0 = (br.pos >> 3) - 7;
    uint64_t w;
    memcpy(&w, src + b0, 8);
    int avail = int(br.pos - 8 * b0);
    while (avail >= mb && i < count) {
      const uint32_t v = uint32_t(w >> (avail - mb)) & mask;
      out[i++] = sym[v];
      avail -= nb[v];
    }
    br.pos = 8 * b0 + avail;
  }
  for (; i < count; ++i) {  // the last bits, zeros below bit 0
    const uint32_t v = uint32_t(br.peek(mb));
    out[i] = sym[v];
    br.pos -= nb[v];
  }
  if (br.pos != 0) fail("Huffman stream: %lld bits left over", (long long)br.pos);
}

// ---- sequences (3.1.1.3.2) -------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,   4,    5,    6,    7,    8,    9,    10,    11,    12,   13,
                              14,  15,   16,   17,   18,   19,   20,   21,    22,    23,   24,
                              25,  26,   27,   28,   29,   30,   31,   32,    33,    34,   35,
                              37,  39,   41,   43,   47,   51,   59,   67,    83,    99,   131,
                              259, 515,  1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum { LL = 0, OF = 1, ML = 2 };
const int kMaxAl[3] = {9, 8, 9};
const int kMaxCode[3] = {35, 31, 52};
const char* const kSeqName[3] = {"literal lengths", "offsets", "match lengths"};

const Fse& default_table(int kind) {
  static const Fse ll = fse_build(kLLDefault, 36, 6);
  static const Fse of = fse_build(kOFDefault, 29, 5);
  static const Fse ml = fse_build(kMLDefault, 53, 6);
  return kind == LL ? ll : kind == OF ? of : ml;
}

// ---- frames ------------------------------------------------------------------

struct Frame {
  uint8_t* dst;
  size_t cap;
  size_t start;  // first byte of this frame's output
  size_t pos;    // bytes written
  uint64_t rep[3] = {1, 4, 8};
  Huffman huf;
  Fse tables[3];
  bool have[3] = {false, false, false};
  std::vector<uint8_t> lit;
  int64_t* modes;

  void need(size_t more) {
    if (more > cap - pos)
      fail("output past the expected size of %llu bytes", (unsigned long long)cap);
  }
};

size_t read_literals(const uint8_t* src, size_t n, Frame& f) {
  if (n == 0) fail("compressed block: no literals section");
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type < 2) {
    size_t hs, regen;
    if (sf == 0 || sf == 2) {
      hs = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < hs) fail("literals: truncated header");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hs = 3;
      if (n < hs) fail("literals: truncated header");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kBlockMax) fail("literals: %zu bytes exceed the block maximum", regen);
    f.lit.resize(regen);
    if (type == 0) {
      if (hs + regen > n) fail("literals: truncated raw literals");
      if (regen) memcpy(f.lit.data(), src + hs, regen);
      ++f.modes[LIT_RAW];
      return hs + regen;
    }
    if (hs + 1 > n) fail("literals: truncated RLE literals");
    memset(f.lit.data(), src[hs], regen);
    ++f.modes[LIT_RLE];
    return hs + 1;
  }
  int hs, bits;
  bool four = sf != 0;
  if (sf < 2) {
    hs = 3;
    bits = 10;
  } else if (sf == 2) {
    hs = 4;
    bits = 14;
  } else {
    hs = 5;
    bits = 18;
  }
  if (n < size_t(hs)) fail("literals: truncated header");
  const uint64_t hdr = le_n(src, hs), mask = (uint64_t(1) << bits) - 1;
  const size_t regen = (hdr >> 4) & mask, csize = (hdr >> (4 + bits)) & mask;
  if (regen > kBlockMax) fail("literals: %zu bytes exceed the block maximum", regen);
  if (hs + csize > n) fail("literals: truncated Huffman literals");
  const uint8_t* p = src + hs;
  size_t rem = csize;
  if (type == 2) {
    size_t k = huf_read(p, rem, f.huf, f.modes);
    p += k;
    rem -= k;
    ++f.modes[LIT_HUFFMAN];
  } else {
    if (!f.huf.valid) fail("literals: treeless literals without an earlier Huffman table");
    ++f.modes[LIT_TREELESS];
  }
  f.lit.resize(regen);
  if (!four) {
    huf_stream(f.huf, p, rem, f.lit.data(), regen);
    ++f.modes[LIT_1_STREAM];
  } else {
    if (rem < 6) fail("literals: truncated jump table");
    size_t s[4] = {size_t(p[0] | (p[1] << 8)), size_t(p[2] | (p[3] << 8)),
                   size_t(p[4] | (p[5] << 8)), 0};
    if (6 + s[0] + s[1] + s[2] > rem) fail("literals: jump table past the streams");
    s[3] = rem - 6 - s[0] - s[1] - s[2];
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("literals: %zu literals cannot fill 4 streams", regen);
    const uint8_t* q = p + 6;
    for (int i = 0; i < 4; ++i) {
      size_t cnt = i < 3 ? seg : regen - 3 * seg;
      huf_stream(f.huf, q, s[i], f.lit.data() + i * seg, cnt);
      q += s[i];
    }
    ++f.modes[LIT_4_STREAMS];
  }
  return hs + csize;
}

void execute(Frame& f, size_t block_start, uint64_t ll, uint64_t ml, uint64_t ofv,
             size_t& lit_pos) {
  if (ll > f.lit.size() - lit_pos) fail("sequence: literal length past the literals");
  f.need(ll + ml);
  if (ll) memcpy(f.dst + f.pos, f.lit.data() + lit_pos, ll);
  f.pos += ll;
  lit_pos += ll;
  uint64_t offset;
  if (ofv > 3) {
    offset = ofv - 3;
    f.rep[2] = f.rep[1];
    f.rep[1] = f.rep[0];
    f.rep[0] = offset;
    ++f.modes[OFFSET_NEW];
  } else {
    const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
    if (idx == 0) {
      offset = f.rep[0];
      ++f.modes[OFFSET_REPEAT_1];
    } else if (idx == 1) {
      offset = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
      ++f.modes[OFFSET_REPEAT_2];
    } else {
      if (idx == 2) {
        offset = f.rep[2];
        ++f.modes[OFFSET_REPEAT_3];
      } else {
        offset = f.rep[0] - 1;
        ++f.modes[OFFSET_REPEAT_1_MINUS_1];
      }
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    }
  }
  if (offset == 0 || offset > f.pos - f.start)
    fail("sequence: offset %llu before the start of the frame", (unsigned long long)offset);
  if (offset > f.pos - block_start) ++f.modes[MATCH_ACROSS_BLOCKS];
  uint8_t* out = f.dst + f.pos;
  const uint8_t* from = out - offset;
  if (offset >= ml) {
    memcpy(out, from, ml);
  } else {
    for (uint64_t i = 0; i < ml; ++i) out[i] = from[i];
  }
  f.pos += ml;
}

void read_sequences(const uint8_t* src, size_t n, Frame& f, size_t block_start) {
  if (n == 0) fail("compressed block: no sequences section");
  size_t i;
  uint32_t nseq;
  const uint8_t b0 = src[0];
  if (b0 < 128) {
    nseq = b0;
    i = 1;
  } else if (b0 < 255) {
    if (n < 2) fail("sequences: truncated header");
    nseq = ((b0 - 128u) << 8) + src[1];
    i = 2;
  } else {
    if (n < 3) fail("sequences: truncated header");
    nseq = src[1] + (uint32_t(src[2]) << 8) + 0x7F00;
    i = 3;
  }
  size_t lit_pos = 0;
  if (nseq == 0) {
    if (i != n) fail("sequences: bytes after an empty sequences section");
    ++f.modes[SEQ_NONE];
  } else {
    if (i >= n) fail("sequences: truncated header");
    const uint8_t m = src[i++];
    if (m & 3) fail("sequences: reserved bits set in the compression modes");
    const int mode[3] = {m >> 6, (m >> 4) & 3, (m >> 2) & 3};  // LL, OF, ML
    // tables come in the order literal lengths, offsets, match lengths
    for (int kind : {LL, OF, ML}) {
      switch (mode[kind]) {
        case 0:
          f.tables[kind] = default_table(kind);
          ++f.modes[SEQ_PREDEFINED];
          break;
        case 1: {
          if (i >= n) fail("sequences: truncated RLE %s", kSeqName[kind]);
          const int sym = src[i++];
          if (sym > kMaxCode[kind]) fail("sequences: RLE %s code %d", kSeqName[kind], sym);
          f.tables[kind] = fse_rle(sym);
          ++f.modes[SEQ_RLE];
          break;
        }
        case 2:
          i += fse_read(src + i, n - i, kMaxAl[kind], kMaxCode[kind], f.tables[kind],
                        kSeqName[kind]);
          ++f.modes[SEQ_FSE];
          break;
        default:
          if (!f.have[kind]) fail("sequences: repeat %s without an earlier table", kSeqName[kind]);
          ++f.modes[SEQ_REPEAT];
      }
      f.have[kind] = true;
    }
    const Fse &ll_t = f.tables[LL], &of_t = f.tables[OF], &ml_t = f.tables[ML];
    BackBits br(src + i, n - i, "sequences");
    uint32_t ls = uint32_t(br.read(ll_t.al)), os = uint32_t(br.read(of_t.al)),
             ms = uint32_t(br.read(ml_t.al));
    for (uint32_t k = 0; k < nseq; ++k) {
      const int oc = of_t.t[os].sym, mc = ml_t.t[ms].sym, lc = ll_t.t[ls].sym;
      const uint64_t ofv = (uint64_t(1) << oc) + br.read(oc);
      const uint64_t ml = kMLBase[mc] + br.read(kMLBits[mc]);
      const uint64_t ll = kLLBase[lc] + br.read(kLLBits[lc]);
      if (k + 1 < nseq) {
        ls = ll_t.t[ls].base + uint32_t(br.read(ll_t.t[ls].nb));
        ms = ml_t.t[ms].base + uint32_t(br.read(ml_t.t[ms].nb));
        os = of_t.t[os].base + uint32_t(br.read(of_t.t[os].nb));
      }
      if (br.pos < 0) fail("sequences: bitstream overrun at sequence %u", k);
      execute(f, block_start, ll, ml, ofv, lit_pos);
    }
    if (br.pos != 0) fail("sequences: %lld bits left over", (long long)br.pos);
  }
  const size_t rest = f.lit.size() - lit_pos;
  f.need(rest);
  if (rest) memcpy(f.dst + f.pos, f.lit.data() + lit_pos, rest);
  f.pos += rest;
}

struct Header {
  size_t size;  // header bytes after the magic
  bool single, checksum, has_fcs;
  uint64_t fcs, window;
};

Header read_header(const uint8_t* src, size_t n) {
  if (n < 1) fail("frame: truncated header");
  const uint8_t d = src[0];
  Header h{};
  h.single = (d >> 5) & 1;
  h.checksum = (d >> 2) & 1;
  if ((d >> 3) & 1) fail("frame: reserved header bit set");
  const int fcs_flag = d >> 6, did_flag = d & 3;
  size_t i = 1;
  if (!h.single) {
    if (i >= n) fail("frame: truncated window descriptor");
    const int e = src[i] >> 3, m = src[i] & 7;
    const uint64_t base = uint64_t(1) << (10 + e);
    h.window = base + (base / 8) * m;
    ++i;
  }
  static const int kDid[4] = {0, 1, 2, 4};
  const int dsz = kDid[did_flag];
  if (i + dsz > n) fail("frame: truncated dictionary id");
  const uint64_t did = le_n(src + i, dsz);
  if (did != 0) fail("frame: dictionary id %llu (frames with a dictionary are not read)",
                     (unsigned long long)did);
  i += dsz;
  const int fsz = fcs_flag == 0 ? (h.single ? 1 : 0) : (fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8);
  if (i + fsz > n) fail("frame: truncated content size");
  h.has_fcs = fsz > 0;
  h.fcs = le_n(src + i, fsz) + (fsz == 2 ? 256 : 0);
  i += fsz;
  if (h.single) h.window = h.fcs;
  h.size = i;
  return h;
}

// walks the blocks of a frame without decoding them; returns its length
size_t frame_length(const uint8_t* src, size_t n, const Header& h) {
  size_t i = 4 + h.size;
  for (;;) {
    if (i + 3 > n) fail("frame: truncated block header");
    const uint32_t bh = src[i] | (src[i + 1] << 8) | (uint32_t(src[i + 2]) << 16);
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) fail("block: reserved block type");
    i += 3 + (type == 1 ? 1 : bsize);
    if (i > n) fail("frame: truncated block");
    if (bh & 1) break;
  }
  return i + (h.checksum ? 4 : 0);
}

size_t decode_frame(const uint8_t* src, size_t n, Frame& f) {
  const Header h = read_header(src + 4, n - 4);
  ++f.modes[h.single ? FRAME_SINGLE_SEGMENT : FRAME_WINDOWED];
  if (!h.has_fcs) ++f.modes[FRAME_NO_CONTENT_SIZE];
  f.start = f.pos;
  if (h.has_fcs && h.fcs > f.cap - f.pos)
    fail("frame: content size %llu past the expected size of %llu bytes",
         (unsigned long long)h.fcs, (unsigned long long)f.cap);
  size_t i = 4 + h.size;
  for (;;) {
    if (i + 3 > n) fail("frame: truncated block header");
    const uint32_t bh = src[i] | (src[i + 1] << 8) | (uint32_t(src[i + 2]) << 16);
    i += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    const size_t block_start = f.pos;
    if (type == 3) fail("block: reserved block type");
    if (bsize > kBlockMax) fail("block: %zu bytes exceed the block maximum", bsize);
    if (type == 0) {
      if (i + bsize > n) fail("block: truncated raw block");
      f.need(bsize);
      memcpy(f.dst + f.pos, src + i, bsize);
      f.pos += bsize;
      i += bsize;
      ++f.modes[BLOCK_RAW];
    } else if (type == 1) {
      if (i + 1 > n) fail("block: truncated RLE block");
      f.need(bsize);
      memset(f.dst + f.pos, src[i], bsize);
      f.pos += bsize;
      i += 1;
      ++f.modes[BLOCK_RLE];
    } else {
      if (i + bsize > n) fail("block: truncated compressed block");
      const size_t k = read_literals(src + i, bsize, f);
      read_sequences(src + i + k, bsize - k, f, block_start);
      if (f.pos - block_start > kBlockMax) fail("block: decodes past the block maximum");
      i += bsize;
      ++f.modes[BLOCK_COMPRESSED];
    }
    if (last) break;
  }
  const size_t got = f.pos - f.start;
  if (h.has_fcs && got != h.fcs)
    fail("frame: decoded %zu bytes, header says %llu", got, (unsigned long long)h.fcs);
  if (h.checksum) {
    if (i + 4 > n) fail("frame: truncated checksum");
    const uint32_t want = le32(src + i);
    const uint32_t have = uint32_t(xxh64(f.dst + f.start, got));
    if (want != have) fail("frame: content checksum mismatch (%08x, computed %08x)", want, have);
    i += 4;
    ++f.modes[FRAME_CHECKSUM];
  }
  return i;
}

void copy_error(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.msg.c_str());
}

}  // namespace

extern "C" {

int ctpn_zstd_nmodes() { return N_MODES; }

const char* ctpn_zstd_mode_name(int i) { return i >= 0 && i < N_MODES ? kModeNames[i] : ""; }

int64_t ctpn_zstd_content_size(const uint8_t* src, uint64_t n, char* err, int errlen) {
  try {
    if (n == 0) fail("empty input");
    uint64_t total = 0;
    bool known = true;
    size_t i = 0;
    while (i < n) {
      if (n - i < 8) fail("truncated frame at byte %zu", i);
      const uint32_t magic = le32(src + i);
      if (magic == kZstdMagic) {
        const Header h = read_header(src + i + 4, n - i - 4);
        known = known && h.has_fcs;
        total += h.fcs;
        i += frame_length(src + i, n - i, h);
      } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        i += 8 + uint64_t(le32(src + i + 4));
      } else {
        fail("unknown frame magic %08x at byte %zu", magic, i);
      }
      if (i > n) fail("truncated frame");
    }
    return known ? int64_t(total) : -1;
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -2;
  }
}

int64_t ctpn_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                             int64_t* modes, char* err, int errlen) {
  try {
    if (n == 0) fail("empty input");
    Frame f;
    f.dst = dst;
    f.cap = cap;
    f.pos = 0;
    f.modes = modes;
    size_t i = 0;
    while (i < n) {
      if (n - i < 4) fail("truncated frame magic at byte %zu", i);
      const uint32_t magic = le32(src + i);
      if (magic == kZstdMagic) {
        // each frame starts with fresh repeat offsets and tables
        f.rep[0] = 1;
        f.rep[1] = 4;
        f.rep[2] = 8;
        f.huf.valid = false;
        f.have[0] = f.have[1] = f.have[2] = false;
        i += decode_frame(src + i, n - i, f);
      } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n - i < 8) fail("truncated skippable frame at byte %zu", i);
        const uint64_t skip = le32(src + i + 4);
        if (skip > n - i - 8) fail("truncated skippable frame at byte %zu", i);
        i += 8 + skip;
        ++modes[FRAME_SKIPPABLE];
      } else {
        fail("unknown frame magic %08x at byte %zu", magic, i);
      }
    }
    return int64_t(f.pos);
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}

}  // extern "C"
