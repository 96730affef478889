// Zstandard frame decoder (RFC 8878), host C++ with a plain C interface.
//
// Reads the zstd frames of the JAX package's Orbax checkpoints (the zarr
// chunks and the OCDBT manifests and nodes, utils/{zstd,ocdbt,orbax}.py)
// on a machine that has neither zstandard nor tensorstore.  It decodes
// every frame the format allows without a dictionary:
//   - raw, RLE and compressed blocks, several blocks a frame, several
//     frames a buffer (skippable frames are skipped);
//   - raw, RLE, compressed and treeless literals, one or four Huffman
//     streams, the Huffman weights direct or FSE-compressed;
//   - the sequences' FSE tables predefined, RLE, read from the frame or
//     repeated from the previous block, and the three repeat offsets;
//   - the optional content checksum (the low 32 bits of XXH64), verified.
// A frame that names a dictionary, a reserved bit or block type, a table
// or bitstream that does not add up, an offset before the frame's start,
// or output past the caller's capacity is an error, never a guess.
//
// sg_crc32c is the CRC-32C (Castagnoli) that OCDBT puts after each
// manifest and B-tree node; sg_xxh64 is the hash behind the checksum.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& m) { throw Error(m); }

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) {
  return rd32(p) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- bits
// Forward bits, least significant first: the FSE table descriptions.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits read
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ull << nb) - 1));
  }
  void skip(int nb) { pos += nb; }
};

// Backward bits: the Huffman streams and the sequences.  The stream's
// last byte holds a marker bit above its first bit; reads go down from
// there, and a read past the start gets zeros below it (pos < 0).
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits not yet read
  void init(const uint8_t* src, size_t size, const char* what) {
    if (size == 0) fail(std::string(what) + ": empty bitstream");
    if (src[size - 1] == 0) fail(std::string(what) + ": bitstream ends in a zero byte");
    p = src;
    n = size;
    pos = int64_t(size - 1) * 8 + highbit(src[size - 1]);
  }
  uint64_t bits_at(int64_t at, int nb) const {  // nb <= 56, at >= 0
    size_t byte = size_t(at >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      std::memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (v >> (at & 7)) & ((1ull << nb) - 1);
  }
  uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t at = pos - nb;
    if (at >= 0) return bits_at(at, nb);
    int64_t have = pos;  // the bits above the start, shifted up
    if (have <= 0) return 0;
    return bits_at(0, int(have)) << (-at);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflow() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

// ----------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t sym;
  uint8_t nb;
  uint16_t base;
};

struct Fse {
  int log = 0;
  bool valid = false;
  std::vector<FseEntry> t;
};

void build_fse(Fse& f, const int16_t* norm, int max_sym, int log) {
  const uint32_t size = 1u << log;
  f.t.assign(size, FseEntry{0, 0, 0});
  f.log = log;
  std::vector<uint32_t> next(max_sym + 1);
  uint32_t high = size - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      f.t[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].sym = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: the symbols do not fill the table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t ns = next[f.t[u].sym]++;
    int nb = log - highbit(ns);
    f.t[u].nb = uint8_t(nb);
    f.t[u].base = uint16_t((ns << nb) - size);
  }
  f.valid = true;
}

void rle_fse(Fse& f, int sym) {
  f.log = 0;
  f.t.assign(1, FseEntry{uint16_t(sym), 0, 0});
  f.valid = true;
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t read_fse_desc(const uint8_t* src, size_t n, int max_sym, int max_log,
                     Fse& f, const char* what) {
  if (n == 0) fail(std::string(what) + ": FSE table description missing");
  FwdBits b{src, n};
  int log = int(b.peek(4)) + 5;
  b.skip(4);
  if (log > max_log)
    fail(std::string(what) + ": FSE accuracy log " + std::to_string(log) +
         " above " + std::to_string(max_log));
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = b.peek(2);
        b.skip(2);
        n0 += int(r);
        if (r != 3) break;
        if (b.pos > n * 8) break;
      }
      if (n0 > max_sym) fail(std::string(what) + ": FSE zero run past the last symbol");
      while (sym < n0) norm[sym++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = b.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      b.skip(nbits - 1);
    } else {
      count = int(b.peek(nbits));
      if (count >= threshold) count -= max;
      b.skip(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (b.pos > n * 8) fail(std::string(what) + ": FSE table description truncated");
  }
  if (remaining != 1) fail(std::string(what) + ": FSE probabilities do not sum to the table");
  build_fse(f, norm, sym - 1, log);
  return (b.pos + 7) / 8;
}

// ------------------------------------------------------------- Huffman
struct Huf {
  int max_bits = 0;
  bool valid = false;
  std::vector<uint16_t> t;  // symbol | bits << 8, indexed by max_bits peeked bits
};

size_t read_huf(const uint8_t* src, size_t n, Huf& h) {
  if (n == 0) fail("literals: Huffman tree description missing");
  const uint8_t hb = src[0];
  uint8_t w[256];
  int nw = 0;
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    size_t bytes = size_t(nw + 1) / 2;
    if (1 + bytes > n) fail("literals: Huffman weights truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t byte = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? byte >> 4 : byte & 15;
    }
    used = 1 + bytes;
  } else {
    const size_t cs = hb;
    if (cs == 0 || 1 + cs > n) fail("literals: Huffman weights truncated");
    Fse f;
    size_t d = read_fse_desc(src + 1, cs, 255, 6, f, "Huffman weights");
    if (d >= cs) fail("literals: Huffman weights without a bitstream");
    BackBits b;
    b.init(src + 1 + d, cs - d, "Huffman weights");
    uint32_t s1 = uint32_t(b.read(f.log)), s2 = uint32_t(b.read(f.log));
    for (;;) {
      if (nw > 253) fail("literals: more than 255 Huffman weights");
      w[nw++] = uint8_t(f.t[s1].sym);
      s1 = f.t[s1].base + uint32_t(b.read(f.t[s1].nb));
      if (b.overflow()) {
        w[nw++] = uint8_t(f.t[s2].sym);
        break;
      }
      w[nw++] = uint8_t(f.t[s2].sym);
      s2 = f.t[s2].base + uint32_t(b.read(f.t[s2].nb));
      if (b.overflow()) {
        w[nw++] = uint8_t(f.t[s1].sym);
        break;
      }
    }
    used = 1 + cs;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("literals: Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("literals: Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("literals: Huffman code longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("literals: Huffman weights do not complete a tree");
  w[nw++] = uint8_t(highbit(rest) + 1);
  h.max_bits = max_bits;
  h.t.assign(size_t(1) << max_bits, 0);
  uint32_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != wt) continue;
      const uint16_t e = uint16_t(s | ((max_bits + 1 - wt) << 8));
      const uint32_t len = 1u << (wt - 1);
      for (uint32_t i = 0; i < len; ++i) h.t[pos + i] = e;
      pos += len;
    }
  }
  h.valid = true;
  return used;
}

// One Huffman stream's decoder: symbols go to out[i, cnt).
struct HufStream {
  BackBits b;
  uint8_t* out;
  size_t i = 0, cnt;
  HufStream(const uint8_t* src, size_t n, uint8_t* o, size_t c) : out(o), cnt(c) {
    b.init(src, n, "Huffman stream");
  }
  // Five symbols of at most 11 bits from one load of the 57 bits below
  // pos; false (nothing done) where those bits or symbols run out.
  bool five(const uint16_t* t, int mb, uint64_t mask) {
    if (cnt - i < 5 || b.pos < 64) return false;
    const int64_t at = b.pos - 57;
    uint64_t w;
    std::memcpy(&w, b.p + (at >> 3), 8);
    w >>= at & 7;
    int avail = 57;
    for (int k = 0; k < 5; ++k) {
      const uint16_t e = t[(w >> (avail - mb)) & mask];
      out[i++] = uint8_t(e);
      avail -= e >> 8;
    }
    b.pos -= 57 - avail;
    return true;
  }
  void rest(const uint16_t* t, int mb, uint64_t mask) {
    while (five(t, mb, mask)) {
    }
    for (; i < cnt; ++i) {
      const uint16_t e = t[b.peek(mb)];
      out[i] = uint8_t(e);
      b.pos -= e >> 8;
    }
    if (!b.done()) fail("Huffman stream not consumed exactly");
  }
};

// ``k`` streams decoded side by side (their loads and lookups overlap),
// each finished alone.
void huf_streams(const Huf& h, HufStream* s, int k) {
  const int mb = h.max_bits;
  const uint64_t mask = (1ull << mb) - 1;
  const uint16_t* t = h.t.data();
  if (k == 4) {
    while (s[0].five(t, mb, mask) && s[1].five(t, mb, mask) &&
           s[2].five(t, mb, mask) && s[3].five(t, mb, mask)) {
    }
  }
  for (int j = 0; j < k; ++j) s[j].rest(t, mb, mask);
}

// ----------------------------------------------------------- sequences
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum { LL = 0, OF = 1, ML = 2 };
const int kMaxSym[3] = {35, 31, 52};
const int kMaxLog[3] = {9, 8, 9};
const char* const kName[3] = {"literal lengths", "offsets", "match lengths"};

// What a frame's blocks hand on to the next: the tables and offsets.
struct FrameState {
  Huf huf;
  Fse fse[3];
  uint64_t rep[3] = {1, 4, 8};
};

struct Out {
  uint8_t* dst;
  size_t cap;
  size_t pos;    // bytes written in the buffer
  size_t start;  // this frame's first byte
  void need(size_t k) const {
    if (k > cap - pos) fail("output past its capacity of " + std::to_string(cap) + " bytes");
  }
};

size_t read_literals(const uint8_t* src, size_t n, FrameState& st, uint8_t* lit,
                     size_t& lit_size) {
  if (n == 0) fail("literals section missing");
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type <= 1) {
    size_t hs, size;
    if (sf == 0 || sf == 2) {
      hs = 1;
      size = src[0] >> 3;
    } else if (sf == 1) {
      if (n < 2) fail("literals header truncated");
      hs = 2;
      size = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (n < 3) fail("literals header truncated");
      hs = 3;
      size = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (size > kBlockMax) fail("literals larger than a block");
    lit_size = size;
    if (type == 0) {
      if (hs + size > n) fail("raw literals truncated");
      std::memcpy(lit, src + hs, size);
      return hs + size;
    }
    if (hs + 1 > n) fail("RLE literals truncated");
    std::memset(lit, src[hs], size);
    return hs + 1;
  }
  size_t hs, regen, comp;
  int streams = sf == 0 ? 1 : 4;
  if (sf <= 1) {
    if (n < 3) fail("literals header truncated");
    hs = 3;
    uint32_t v = rd24(src);
    regen = (v >> 4) & 0x3FF;
    comp = (v >> 14) & 0x3FF;
  } else if (sf == 2) {
    if (n < 4) fail("literals header truncated");
    hs = 4;
    uint32_t v = rd32(src);
    regen = (v >> 4) & 0x3FFF;
    comp = (v >> 18) & 0x3FFF;
  } else {
    if (n < 5) fail("literals header truncated");
    hs = 5;
    uint64_t v = rd32(src) | (uint64_t(src[4]) << 32);
    regen = size_t((v >> 4) & 0x3FFFF);
    comp = size_t((v >> 22) & 0x3FFFF);
  }
  if (regen > kBlockMax) fail("literals larger than a block");
  if (hs + comp > n) fail("compressed literals truncated");
  const uint8_t* p = src + hs;
  size_t left = comp;
  if (type == 2) {
    size_t used = read_huf(p, left, st.huf);
    if (used > left) fail("Huffman tree past the literals");
    p += used;
    left -= used;
  } else if (!st.huf.valid) {
    fail("treeless literals with no earlier Huffman table in the frame");
  }
  lit_size = regen;
  if (streams == 1) {
    HufStream one(p, left, lit, regen);
    huf_streams(st.huf, &one, 1);
  } else {
    if (left < 6) fail("literals: jump table truncated");
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    if (6 + s1 + s2 + s3 > left) fail("literals: jump table past the streams");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("literals: four streams of fewer than four bytes' worth");
    const uint8_t* q = p + 6;
    HufStream four[4] = {HufStream(q, s1, lit, seg),
                         HufStream(q + s1, s2, lit + seg, seg),
                         HufStream(q + s1 + s2, s3, lit + 2 * seg, seg),
                         HufStream(q + s1 + s2 + s3, s4, lit + 3 * seg,
                                   regen - 3 * seg)};
    huf_streams(st.huf, four, 4);
  }
  return hs + comp;
}

void default_fse(Fse& f, int k) {
  if (k == LL) build_fse(f, kLLDefault, 35, 6);
  else if (k == ML) build_fse(f, kMLDefault, 52, 6);
  else build_fse(f, kOFDefault, 28, 5);
}

void copy_match(Out& o, uint64_t off, uint32_t ml) {
  if (off == 0 || off > o.pos - o.start) fail("match offset before the frame's start");
  o.need(ml);
  uint8_t* d = o.dst + o.pos;
  const uint8_t* s = d - off;
  if (off >= ml) {
    std::memcpy(d, s, ml);
  } else {
    for (uint32_t i = 0; i < ml; ++i) d[i] = s[i];
  }
  o.pos += ml;
}

void compressed_block(const uint8_t* src, size_t n, FrameState& st, Out& o,
                      std::vector<uint8_t>& lit) {
  size_t lit_size = 0;
  size_t p = read_literals(src, n, st, lit.data(), lit_size);
  if (p >= n) fail("sequences section missing");
  uint32_t nseq;
  const uint8_t b0 = src[p];
  if (b0 == 0) {
    nseq = 0;
    p += 1;
  } else if (b0 < 128) {
    nseq = b0;
    p += 1;
  } else if (b0 < 255) {
    if (p + 2 > n) fail("sequences header truncated");
    nseq = ((b0 - 128u) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > n) fail("sequences header truncated");
    nseq = src[p + 1] + (uint32_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  size_t lp = 0;
  if (nseq) {
    if (p >= n) fail("sequences header truncated");
    const uint8_t modes = src[p++];
    if (modes & 3) fail("sequences: reserved bits set");
    const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
    for (int k = 0; k < 3; ++k) {
      Fse& f = st.fse[k];
      switch (mode[k]) {
        case 0:
          default_fse(f, k);
          break;
        case 1:
          if (p >= n) fail(std::string(kName[k]) + ": RLE symbol missing");
          if (src[p] > kMaxSym[k]) fail(std::string(kName[k]) + ": RLE symbol out of range");
          rle_fse(f, src[p++]);
          break;
        case 2:
          p += read_fse_desc(src + p, n - p, kMaxSym[k], kMaxLog[k], f, kName[k]);
          if (p > n) fail(std::string(kName[k]) + ": FSE table description truncated");
          break;
        default:
          if (!f.valid)
            fail(std::string(kName[k]) + ": repeat mode with no earlier table in the frame");
      }
    }
    BackBits b;
    b.init(src + p, n - p, "sequences");
    const Fse &tl = st.fse[LL], &to = st.fse[OF], &tm = st.fse[ML];
    uint32_t sl = uint32_t(b.read(tl.log));
    uint32_t so = uint32_t(b.read(to.log));
    uint32_t sm = uint32_t(b.read(tm.log));
    uint64_t* rep = st.rep;
    for (uint32_t i = 0; i < nseq; ++i) {
      const uint32_t oc = to.t[so].sym, lc = tl.t[sl].sym, mc = tm.t[sm].sym;
      if (oc > 31) fail("offset code above 31");
      if (lc > 35 || mc > 52) fail("length code out of range");
      const uint64_t ofv = (1ull << oc) + b.read(int(oc));
      const uint32_t ml = kMLBase[mc] + uint32_t(b.read(kMLBits[mc]));
      const uint32_t ll = kLLBase[lc] + uint32_t(b.read(kLLBits[lc]));
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        const uint32_t idx = uint32_t(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sl = tl.t[sl].base + uint32_t(b.read(tl.t[sl].nb));
        sm = tm.t[sm].base + uint32_t(b.read(tm.t[sm].nb));
        so = to.t[so].base + uint32_t(b.read(to.t[so].nb));
      }
      if (b.overflow()) fail("sequences bitstream read past its start");
      if (ll > lit_size - lp) fail("sequence takes more literals than the block has");
      o.need(ll);
      std::memcpy(o.dst + o.pos, lit.data() + lp, ll);
      o.pos += ll;
      lp += ll;
      copy_match(o, off, ml);
    }
    if (!b.done()) fail("sequences bitstream not consumed exactly");
  } else if (p != n) {
    fail("bytes after a block with no sequences");
  }
  const size_t rest = lit_size - lp;
  o.need(rest);
  std::memcpy(o.dst + o.pos, lit.data() + lp, rest);
  o.pos += rest;
}

struct Header {
  size_t size;          // header bytes after the magic
  bool checksum;
  bool has_fcs;
  uint64_t fcs;
};

Header frame_header(const uint8_t* src, size_t n) {
  if (n < 5) fail("frame header truncated");
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("frame header: reserved bit set");
  Header h{0, bool((fhd >> 2) & 1), false, 0};
  size_t p = 5;
  if (!single) p += 1;  // window descriptor
  const size_t dict_bytes[4] = {0, 1, 2, 4};
  const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
  if (p + dict_bytes[dict_flag] + fcs_bytes > n) fail("frame header truncated");
  uint32_t dict = 0;
  for (size_t i = 0; i < dict_bytes[dict_flag]; ++i) dict |= uint32_t(src[p + i]) << (8 * i);
  if (dict) fail("frame asks for dictionary " + std::to_string(dict) + "; none is read");
  p += dict_bytes[dict_flag];
  if (fcs_bytes) {
    h.has_fcs = true;
    if (fcs_bytes == 1) h.fcs = src[p];
    else if (fcs_bytes == 2) h.fcs = rd16(src + p) + 256;
    else if (fcs_bytes == 4) h.fcs = rd32(src + p);
    else h.fcs = rd64(src + p);
  }
  h.size = p + fcs_bytes;
  return h;
}

bool skippable(const uint8_t* src, size_t n, size_t& skip) {
  if (n >= 4 && (rd32(src) & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail("skippable frame truncated");
    skip = 8 + size_t(rd32(src + 4));
    if (skip > n) fail("skippable frame truncated");
    return true;
  }
  return false;
}

// XXH64, seed 0 (the content checksum is its low 32 bits).
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* const end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// One frame from src into o; returns the bytes of src it took.
size_t frame(const uint8_t* src, size_t n, Out& o, std::vector<uint8_t>& lit) {
  const Header h = frame_header(src, n);
  FrameState st;
  o.start = o.pos;
  size_t p = h.size;
  for (;;) {
    if (p + 3 > n) fail("block header truncated");
    const uint32_t bh = rd24(src + p);
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 0) {
      if (p + bsize > n) fail("raw block truncated");
      o.need(bsize);
      std::memcpy(o.dst + o.pos, src + p, bsize);
      o.pos += bsize;
      p += bsize;
    } else if (type == 1) {
      if (p + 1 > n) fail("RLE block truncated");
      o.need(bsize);
      std::memset(o.dst + o.pos, src[p], bsize);
      o.pos += bsize;
      p += 1;
    } else if (type == 2) {
      if (bsize > kBlockMax) fail("compressed block larger than 128 KiB");
      if (p + bsize > n) fail("compressed block truncated");
      compressed_block(src + p, bsize, st, o, lit);
      p += bsize;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  const size_t got = o.pos - o.start;
  if (h.has_fcs && got != h.fcs)
    fail("frame content size " + std::to_string(h.fcs) + " but " + std::to_string(got) +
         " bytes decoded");
  if (h.checksum) {
    if (p + 4 > n) fail("content checksum truncated");
    const uint32_t want = rd32(src + p);
    if (uint32_t(xxh64(o.dst + o.start, got)) != want) fail("content checksum mismatch");
    p += 4;
  }
  return p;
}

// The bytes the frame's blocks can give at most (the content size where
// the header has one); returns the bytes of src it took.
size_t frame_bound(const uint8_t* src, size_t n, uint64_t& bound) {
  const Header h = frame_header(src, n);
  size_t p = h.size;
  uint64_t b = 0;
  for (;;) {
    if (p + 3 > n) fail("block header truncated");
    const uint32_t bh = rd24(src + p);
    p += 3;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) fail("reserved block type");
    b += type == 2 ? kBlockMax : bsize;
    p += type == 1 ? 1 : bsize;
    if (p > n) fail("block truncated");
    if (bh & 1) break;
  }
  if (h.checksum) p += 4;
  if (p > n) fail("content checksum truncated");
  bound += h.has_fcs ? h.fcs : b;
  return p;
}

void copy_err(const char* m, char* err, size_t errlen) {
  if (err && errlen) std::snprintf(err, errlen, "%s", m);
}

uint32_t crc_table[256];
bool crc_ready = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[i] = c;
  }
  return true;
}();

}  // namespace

extern "C" {

// The most bytes that the frames in src[0, n) decode to: each frame's
// content size where its header has one, else its raw and RLE blocks'
// sizes plus 128 KiB for each compressed block.  0 on success.
int sg_zstd_bound(const uint8_t* src, size_t n, uint64_t* bound, char* err, size_t errlen) {
  try {
    uint64_t b = 0;
    size_t p = 0, frames = 0;
    while (p < n) {
      size_t skip;
      if (skippable(src + p, n - p, skip)) {
        p += skip;
        continue;
      }
      if (n - p < 4 || rd32(src + p) != kMagic) fail("not a zstd frame (bad magic)");
      p += frame_bound(src + p, n - p, b);
      ++frames;
    }
    if (!frames) fail("no zstd frame");
    *bound = b;
    return 0;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, errlen);
    return 1;
  }
}

// Decode every frame in src[0, n), one after another, into dst[0, cap);
// *out is the bytes written.  0 on success, else 1 with the reason in err.
int sg_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, uint64_t* out,
                       char* err, size_t errlen) {
  try {
    Out o{dst, cap, 0, 0};
    std::vector<uint8_t> lit(kBlockMax + 8);
    size_t p = 0, frames = 0;
    while (p < n) {
      size_t skip;
      if (skippable(src + p, n - p, skip)) {
        p += skip;
        continue;
      }
      if (n - p < 4 || rd32(src + p) != kMagic) fail("not a zstd frame (bad magic)");
      p += frame(src + p, n - p, o, lit);
      ++frames;
    }
    if (!frames) fail("no zstd frame");
    *out = o.pos;
    return 0;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, errlen);
    return 1;
  }
}

uint64_t sg_xxh64(const uint8_t* src, size_t n) { return xxh64(src, n); }

uint32_t sg_crc32c(const uint8_t* src, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
