// Zstandard frame decoder (RFC 8878) and CRC-32C, for reading the JAX
// package's orbax/OCDBT checkpoints without libzstd.
//
// Covers every part of the format a compressor without a dictionary emits:
// raw, RLE and compressed blocks; raw, RLE, Huffman (one and four streams)
// and treeless literals; predefined, RLE, FSE-compressed and repeat modes
// for the three sequence codes, with the repeat offsets; windows, several
// frames back to back, skippable frames, and the XXH64 content checksum.
// A dictionary ID, a reserved bit or field, and any malformed input make
// the call fail with a negative code; every read is bounds-checked and
// every write checked against the output's capacity.
//
// C ABI (ctypes, see ocdbt.py):
//   mwx_zstd_decompress(src, n, dst, cap)    decode every frame into dst;
//       the decoded size, or a negative code (-14 when the content does
//       not fit in cap).
//   mwx_zstd_decompress_alloc(src, n, &out)  the same into a buffer that
//       grows as the content needs; free it with mwx_zstd_free.
//   mwx_zstd_error(code)                     the code's message.
//   mwx_crc32c(data, n)                      CRC-32C (Castagnoli).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Err : int64_t {
  E_TRUNCATED = -1,
  E_MAGIC = -2,
  E_RESERVED = -3,
  E_DICTIONARY = -4,
  E_BLOCK_TYPE = -5,
  E_BLOCK_SIZE = -6,
  E_LITERALS = -7,
  E_HUFFMAN = -8,
  E_FSE = -9,
  E_SEQUENCES = -10,
  E_OFFSET = -11,
  E_CHECKSUM = -12,
  E_CONTENT_SIZE = -13,
  E_TOO_SMALL = -14,
  E_NO_MEMORY = -15,
  E_WINDOW = -16,
};

const char* error_message(int64_t code) {
  switch (code) {
    case E_TRUNCATED: return "input truncated";
    case E_MAGIC: return "not a zstd frame (bad magic number)";
    case E_RESERVED: return "reserved bit or value set";
    case E_DICTIONARY: return "frame needs a dictionary (unsupported)";
    case E_BLOCK_TYPE: return "reserved block type";
    case E_BLOCK_SIZE: return "block larger than 128 KiB";
    case E_LITERALS: return "corrupt literals section";
    case E_HUFFMAN: return "corrupt Huffman table or stream";
    case E_FSE: return "corrupt FSE table or stream";
    case E_SEQUENCES: return "corrupt sequences section";
    case E_OFFSET: return "match offset beyond the window or decoded data";
    case E_CHECKSUM: return "content checksum mismatch";
    case E_CONTENT_SIZE: return "decoded size differs from the frame's content size";
    case E_TOO_SMALL: return "output buffer too small";
    case E_NO_MEMORY: return "out of memory";
    case E_WINDOW: return "window size out of range";
    default: return "unknown error";
  }
}

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kReserveMax = uint64_t(64) << 20;

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- output --

struct Output {
  uint8_t* data;
  size_t size;
  size_t cap;
  bool growable;

  void reserve(size_t extra) {
    if (extra <= cap - size) return;
    if (!growable) fail(E_TOO_SMALL);
    if (extra > SIZE_MAX / 2 - size) fail(E_NO_MEMORY);
    size_t want = size + extra;
    size_t next = cap ? cap : 4096;
    while (next < want) next <<= 1;
    auto* p = static_cast<uint8_t*>(std::realloc(data, next));
    if (!p) fail(E_NO_MEMORY);
    data = p;
    cap = next;
  }
};

// ------------------------------------------------------------ bit readers --

// Forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit;

  uint32_t peek(int count) const {  // bits past the end read as 0
    uint32_t v = 0;
    for (int i = 0; i < count; i++) {
      size_t b = bit + i;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t read(int count) {
    if (((bit + count + 7) >> 3) > n) fail(E_TRUNCATED);
    uint32_t v = peek(count);
    bit += count;
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit reader (Huffman and FSE bitstreams): the stream is read from
// its last byte toward its first, most significant bit first, starting below
// the highest set bit of the last byte.  `pos` counts the bits not yet read;
// a read past the start yields zeros and leaves `pos` negative.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;

  BackBits(const uint8_t* src, size_t size) : p(src), n(size) {
    if (size == 0 || src[size - 1] == 0) fail(E_TRUNCATED);
    pos = int64_t(8 * (size - 1)) + highbit(src[size - 1]);
  }
  // bits [pos - count, pos) as an integer; count <= 56
  uint64_t peek(int count) const {
    int64_t lo = pos - count;
    if (lo >= 0 && size_t(lo >> 3) + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, p + (lo >> 3), 8);
      return (w >> (lo & 7)) & ((uint64_t(1) << count) - 1);
    }
    uint64_t v = 0;
    for (int i = 0; i < count; i++) {
      int64_t b = lo + i;
      if (b >= 0) v |= uint64_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint64_t read(int count) {
    if (count == 0) return 0;
    uint64_t v = peek(count);
    pos -= count;
    return v;
  }
};

// -------------------------------------------------------------------- FSE --

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
};

// Decoding table from normalized counts (-1 = "less than one").
void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  uint32_t high = size - 1;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.e[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t position = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t.e[position].symbol = uint16_t(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) fail(E_FSE);
  for (uint32_t u = 0; u < size; u++) {
    uint16_t s = t.e[u].symbol;
    uint32_t state = next[s]++;
    int bits = log - highbit(state);
    t.e[u].bits = uint8_t(bits);
    t.e[u].base = uint16_t((state << bits) - size);
  }
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t read_fse(FseTable& t, const uint8_t* src, size_t n, int max_log,
                int max_sym) {
  ForwardBits br{src, n, 0};
  const int log = int(br.read(4)) + 5;
  if (log > max_log) fail(E_FSE);
  int16_t norm[256];
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int bits = log + 1;
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail(E_FSE);
    // a value in [0, remaining]: the smaller ones take bits - 1 bits
    const uint32_t maxv = uint32_t(2 * threshold - 1 - remaining);
    const uint32_t low = br.peek(bits - 1);
    int count;
    if (low < maxv) {
      br.read(bits - 1);
      count = int(low);
    } else {
      uint32_t v = br.read(bits);
      if (v >= uint32_t(threshold)) v -= maxv;
      count = int(v);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail(E_FSE);
    norm[sym++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        const uint32_t repeat = br.read(2);
        for (uint32_t i = 0; i < repeat; i++) {
          if (sym > max_sym) fail(E_FSE);
          norm[sym++] = 0;
        }
        if (repeat != 3) break;
      }
    }
    while (remaining < threshold) {
      bits--;
      threshold >>= 1;
    }
  }
  build_fse(t, norm, sym, log);
  return br.bytes_used();
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.e.assign(1, FseEntry{symbol, 0, 0});
}

// ---------------------------------------------------------------- Huffman --

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> e;
};

// Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t read_huffman(HufTable& t, const uint8_t* src, size_t n) {
  if (n < 1) fail(E_TRUNCATED);
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  const uint32_t header = src[0];
  if (header >= 128) {  // 4-bit weights, two a byte, high nibble first
    nw = int(header) - 127;
    used = 1 + (size_t(nw) + 1) / 2;
    if (used > n) fail(E_TRUNCATED);
    for (int i = 0; i < nw; i++) {
      const uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + header;
    if (header == 0 || used > n) fail(E_TRUNCATED);
    FseTable ft;
    const size_t h = read_fse(ft, src + 1, header, 6, 255);
    if (h >= header) fail(E_HUFFMAN);
    BackBits br(src + 1 + h, header - h);
    uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
    auto emit = [&](uint32_t s) {
      if (nw >= 255) fail(E_HUFFMAN);
      weights[nw++] = uint8_t(ft.e[s].symbol);
    };
    auto advance = [&](uint32_t& s) {  // true once the stream is overread
      const FseEntry& e = ft.e[s];
      s = e.base + uint32_t(br.read(e.bits));
      return br.pos < 0;
    };
    for (;;) {
      emit(s1);
      if (advance(s1)) {
        emit(s2);
        break;
      }
      emit(s2);
      if (advance(s2)) {
        emit(s1);
        break;
      }
    }
  }
  // the last symbol's weight is implied: it completes a power of two
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > 11) fail(E_HUFFMAN);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(E_HUFFMAN);
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(E_HUFFMAN);
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(E_HUFFMAN);
  weights[nw++] = uint8_t(highbit(rest) + 1);

  uint32_t count[13] = {0};
  for (int i = 0; i < nw; i++) count[weights[i]]++;
  uint32_t start[13] = {0};
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; w++) {
    start[w] = next;
    next += count[w] << (w - 1);
  }
  if (next != (1u << max_bits)) fail(E_HUFFMAN);
  t.max_bits = max_bits;
  t.e.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s < nw; s++) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t len = 1u << (w - 1);
    const HufEntry entry{uint8_t(s), uint8_t(max_bits + 1 - w)};
    for (uint32_t i = 0; i < len; i++) t.e[start[w] + i] = entry;
    start[w] += len;
  }
  return used;
}

// Huffman-coded streams, decoded side by side so that their lookups
// overlap: the fast loop takes four symbols (at most 44 bits) of every
// stream from one 56-bit load each, and stays inside each stream because
// pos < 8 * n; the tail of each stream is then read symbol by symbol.
template <int S>
void huffman_streams(const HufTable& t, const uint8_t* const* src,
                     const size_t* n, uint8_t* const* out,
                     const size_t* count) {
  const int mb = t.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  const HufEntry* tab = t.e.data();
  int64_t pos[S];  // locals, not members: stores to out may alias them
  size_t common = count[0];
  for (int k = 0; k < S; k++) {
    pos[k] = BackBits(src[k], n[k]).pos;
    if (count[k] < common) common = count[k];
  }
  size_t i = 0;
  for (; common - i >= 4; i += 4) {
    bool room = true;
    for (int k = 0; k < S; k++) room &= pos[k] >= 56;
    if (!room) break;
#pragma GCC unroll 4
    for (int k = 0; k < S; k++) {
      const int64_t lo = pos[k] - 56;
      uint64_t w;
      std::memcpy(&w, src[k] + (lo >> 3), 8);
      w >>= (lo & 7);
      int avail = 56;
      for (int j = 0; j < 4; j++) {
        const HufEntry e = tab[(w >> (avail - mb)) & mask];
        out[k][i + j] = e.symbol;
        avail -= e.bits;
      }
      pos[k] -= 56 - avail;
    }
  }
  for (int k = 0; k < S; k++) {
    BackBits br(src[k], n[k]);
    br.pos = pos[k];
    for (size_t m = i; m < count[k]; m++) {
      const HufEntry e = tab[br.peek(mb)];
      out[k][m] = e.symbol;
      br.pos -= e.bits;
      if (br.pos < 0) fail(E_HUFFMAN);
    }
    if (br.pos != 0) fail(E_HUFFMAN);
  }
}

// ------------------------------------------------------------------ block --

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals = std::vector<uint8_t>(kBlockMax);
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,     1,     2,    3,    4,    5,    6,
                              7,     8,     9,    10,   11,   12,   13,
                              14,    15,    16,   18,   20,   22,   24,
                              28,    32,    40,   48,   64,   128,  256,
                              512,   1024,  2048, 4096, 8192, 16384,
                              32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,   6,   7,   8,   9,    10,   11,   12,   13,    14,    15,
    16, 17, 18,  19,  20,  21,  22,   23,   24,   25,   26,    27,    28,
    29, 30, 31,  32,  33,  34,  35,   37,   39,   41,   43,    47,    51,
    59, 67, 83,  99,  131, 259, 515,  1027, 2051, 4099, 8195,  16387, 32771,
    65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// Literals section into st.literals; returns the bytes it took.
size_t read_literals(FrameState& st, const uint8_t* src, size_t n,
                     size_t& count) {
  if (n < 1) fail(E_TRUNCATED);
  const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  uint8_t* lit = st.literals.data();
  if (type == 0 || type == 1) {  // raw, RLE
    size_t header;
    if ((fmt & 1) == 0) {
      header = 1;
      count = src[0] >> 3;
    } else if (fmt == 1) {
      header = 2;
      if (n < 2) fail(E_TRUNCATED);
      count = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      header = 3;
      if (n < 3) fail(E_TRUNCATED);
      count = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (count > kBlockMax) fail(E_LITERALS);
    if (type == 0) {
      if (n - header < count) fail(E_TRUNCATED);
      std::memcpy(lit, src + header, count);
      return header + count;
    }
    if (n < header + 1) fail(E_TRUNCATED);
    std::memset(lit, src[header], count);
    return header + 1;
  }
  // compressed (2) or treeless (3): Huffman-coded, in one or four streams
  size_t header, comp;
  if (fmt <= 1) {
    header = 3;
    if (n < 3) fail(E_TRUNCATED);
    const uint64_t c = load_le(src, 3);
    count = (c >> 4) & 0x3FF;
    comp = (c >> 14) & 0x3FF;
  } else if (fmt == 2) {
    header = 4;
    if (n < 4) fail(E_TRUNCATED);
    const uint64_t c = load_le(src, 4);
    count = (c >> 4) & 0x3FFF;
    comp = (c >> 18) & 0x3FFF;
  } else {
    header = 5;
    if (n < 5) fail(E_TRUNCATED);
    const uint64_t c = load_le(src, 5);
    count = (c >> 4) & 0x3FFFF;
    comp = (c >> 22) & 0x3FFFF;
  }
  if (count > kBlockMax) fail(E_LITERALS);
  if (n - header < comp) fail(E_TRUNCATED);
  const uint8_t* p = src + header;
  size_t left = comp;
  if (type == 2) {
    const size_t used = read_huffman(st.huf, p, left);
    st.have_huf = true;
    p += used;
    left -= used;
  } else if (!st.have_huf) {
    fail(E_LITERALS);
  }
  if (fmt == 0) {
    huffman_streams<1>(st.huf, &p, &left, &lit, &count);
  } else {
    if (left < 6) fail(E_TRUNCATED);
    const size_t s1 = load_le(p, 2), s2 = load_le(p + 2, 2),
                 s3 = load_le(p + 4, 2);
    p += 6;
    left -= 6;
    if (s1 + s2 + s3 > left) fail(E_TRUNCATED);
    const size_t seg = (count + 3) / 4;
    if (3 * seg > count) fail(E_LITERALS);
    const uint8_t* srcs[4] = {p, p + s1, p + s1 + s2, p + s1 + s2 + s3};
    const size_t sizes[4] = {s1, s2, s3, left - s1 - s2 - s3};
    uint8_t* outs[4] = {lit, lit + seg, lit + 2 * seg, lit + 3 * seg};
    const size_t counts[4] = {seg, seg, seg, count - 3 * seg};
    huffman_streams<4>(st.huf, srcs, sizes, outs, counts);
  }
  return header + comp;
}

// One sequence code's table by its mode; returns the bytes it took.
size_t read_table(FseTable& t, bool& have, int mode, const uint8_t* src,
                  size_t n, const int16_t* def, int def_n, int def_log,
                  int max_log, int max_sym) {
  switch (mode) {
    case 0:  // predefined
      build_fse(t, def, def_n, def_log);
      have = true;
      return 0;
    case 1:  // RLE
      if (n < 1) fail(E_TRUNCATED);
      if (src[0] > max_sym) fail(E_SEQUENCES);
      rle_fse(t, src[0]);
      have = true;
      return 1;
    case 2: {  // FSE-compressed
      const size_t used = read_fse(t, src, n, max_log, max_sym);
      have = true;
      return used;
    }
    default:  // repeat the previous block's table
      if (!have) fail(E_SEQUENCES);
      return 0;
  }
}

void compressed_block(FrameState& st, const uint8_t* src, size_t n,
                      Output& out, size_t frame_start, uint64_t window) {
  size_t nlit = 0;
  size_t used = read_literals(st, src, n, nlit);
  src += used;
  n -= used;
  const uint8_t* lit = st.literals.data();
  if (n < 1) fail(E_TRUNCATED);
  size_t nseq = src[0];
  size_t h = 1;
  if (nseq == 255) {
    if (n < 3) fail(E_TRUNCATED);
    nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00;
    h = 3;
  } else if (nseq >= 128) {
    if (n < 2) fail(E_TRUNCATED);
    nseq = ((nseq - 128) << 8) + src[1];
    h = 2;
  }
  src += h;
  n -= h;
  const size_t block_start = out.size;
  if (nseq == 0) {
    if (n != 0) fail(E_SEQUENCES);
    out.reserve(nlit);
    std::memcpy(out.data + out.size, lit, nlit);
    out.size += nlit;
    return;
  }
  if (n < 1) fail(E_TRUNCATED);
  const uint8_t modes = src[0];
  if (modes & 3) fail(E_RESERVED);
  src += 1;
  n -= 1;
  used = read_table(st.ll, st.have_ll, modes >> 6, src, n, kLLDefault, 36,
                    6, 9, 35);
  src += used;
  n -= used;
  used = read_table(st.of, st.have_of, (modes >> 4) & 3, src, n, kOFDefault,
                    29, 5, 8, 31);
  src += used;
  n -= used;
  used = read_table(st.ml, st.have_ml, (modes >> 2) & 3, src, n, kMLDefault,
                    53, 6, 9, 52);
  src += used;
  n -= used;

  BackBits br(src, n);
  uint32_t sll = uint32_t(br.read(st.ll.log));
  uint32_t sof = uint32_t(br.read(st.of.log));
  uint32_t sml = uint32_t(br.read(st.ml.log));
  size_t lit_pos = 0;
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < nseq; i++) {
    const FseEntry& ell = st.ll.e[sll];
    const FseEntry& eof = st.of.e[sof];
    const FseEntry& eml = st.ml.e[sml];
    const uint32_t ofc = eof.symbol, mlc = eml.symbol, llc = ell.symbol;
    // extra bits in the stream's order: offset, match length, literals
    const uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
    const uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
    const uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);  // 3: rep[0] - 1
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (offset == 0) fail(E_OFFSET);
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {  // state updates: literals, match length, offset
      sll = ell.base + uint32_t(br.read(ell.bits));
      sml = eml.base + uint32_t(br.read(eml.bits));
      sof = eof.base + uint32_t(br.read(eof.bits));
    }
    if (br.pos < 0) fail(E_SEQUENCES);
    if (ll > nlit - lit_pos) fail(E_SEQUENCES);
    if (ll + ml > kBlockMax - (out.size - block_start)) fail(E_BLOCK_SIZE);
    out.reserve(ll + ml);
    std::memcpy(out.data + out.size, lit + lit_pos, ll);
    out.size += ll;
    lit_pos += ll;
    if (offset > out.size - frame_start || offset > window) fail(E_OFFSET);
    uint8_t* d = out.data + out.size;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (uint64_t k = 0; k < ml; k++) d[k] = s[k];
    }
    out.size += ml;
  }
  if (br.pos != 0) fail(E_SEQUENCES);
  const size_t tail = nlit - lit_pos;
  if (tail > kBlockMax - (out.size - block_start)) fail(E_BLOCK_SIZE);
  out.reserve(tail);
  std::memcpy(out.data + out.size, lit + lit_pos, tail);
  out.size += tail;
}

// ------------------------------------------------------------------ XXH64 --

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  acc ^= xxround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {  // seed 0
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xxround(v1, load_le(p, 8));
      v2 = xxround(v2, load_le(p + 8, 8));
      v3 = xxround(v3, load_le(p + 16, 8));
      v4 = xxround(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (end - p >= 8) {
    h ^= xxround(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= load_le(p, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ frame --

// One frame starting at src (magic included); returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, Output& out) {
  if (n < 4) fail(E_TRUNCATED);
  const uint32_t magic = uint32_t(load_le(src, 4));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n < 8) fail(E_TRUNCATED);
    const uint64_t size = load_le(src + 4, 4);
    if (size > n - 8) fail(E_TRUNCATED);
    return 8 + size_t(size);
  }
  if (magic != 0xFD2FB528u) fail(E_MAGIC);
  size_t p = 4;
  if (n < p + 1) fail(E_TRUNCATED);
  const uint8_t fhd = src[p++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  const int checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 0x08) fail(E_RESERVED);
  uint64_t window = 0;
  if (!single) {
    if (n < p + 1) fail(E_TRUNCATED);
    const uint8_t wd = src[p++];
    const int log = 10 + (wd >> 3);
    if (log > 41) fail(E_WINDOW);
    const uint64_t base = uint64_t(1) << log;
    window = base + (base / 8) * (wd & 7);
  }
  static const int kDidBytes[4] = {0, 1, 2, 4};
  const int did_bytes = kDidBytes[did_flag];
  if (n < p + did_bytes) fail(E_TRUNCATED);
  if (did_bytes && load_le(src + p, did_bytes) != 0) fail(E_DICTIONARY);
  p += did_bytes;
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fcs_bytes = kFcsBytes[fcs_flag];
  if (fcs_flag == 0 && single) fcs_bytes = 1;
  const bool has_size = fcs_bytes > 0;
  uint64_t content = 0;
  if (has_size) {
    if (n < p + fcs_bytes) fail(E_TRUNCATED);
    content = load_le(src + p, fcs_bytes);
    if (fcs_bytes == 2) content += 256;
    p += fcs_bytes;
  }
  if (single) window = content;
  if (has_size) {  // trust a stated size only as far as 64 MiB up front
    if (!out.growable && content > out.cap - out.size) fail(E_TOO_SMALL);
    out.reserve(size_t(content < kReserveMax ? content : kReserveMax));
  }

  FrameState st;
  const size_t frame_start = out.size;
  for (;;) {
    if (n < p + 3) fail(E_TRUNCATED);
    const uint32_t bh = uint32_t(load_le(src + p, 3));
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (size > kBlockMax) fail(E_BLOCK_SIZE);
    if (type == 0) {  // raw
      if (n - p < size) fail(E_TRUNCATED);
      out.reserve(size);
      std::memcpy(out.data + out.size, src + p, size);
      out.size += size;
      p += size;
    } else if (type == 1) {  // RLE
      if (n - p < 1) fail(E_TRUNCATED);
      out.reserve(size);
      std::memset(out.data + out.size, src[p], size);
      out.size += size;
      p += 1;
    } else if (type == 2) {
      if (n - p < size) fail(E_TRUNCATED);
      compressed_block(st, src + p, size, out, frame_start, window);
      p += size;
    } else {
      fail(E_BLOCK_TYPE);
    }
    if (last) break;
  }
  const size_t produced = out.size - frame_start;
  if (has_size && produced != content) fail(E_CONTENT_SIZE);
  if (checksum) {
    if (n - p < 4) fail(E_TRUNCATED);
    const uint32_t want = uint32_t(load_le(src + p, 4));
    const uint32_t got = uint32_t(xxh64(out.data + frame_start, produced));
    if (want != got) fail(E_CHECKSUM);
    p += 4;
  }
  return p;
}

int64_t decode_all(const uint8_t* src, size_t n, Output& out) {
  try {
    if (n == 0) fail(E_TRUNCATED);
    if (out.growable) out.reserve(1);  // data is never null below
    size_t p = 0;
    while (p < n) p += decode_frame(src + p, n - p, out);
    return int64_t(out.size);
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return E_NO_MEMORY;
  }
}

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int k = 1; k < 8; k++)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

}  // namespace

extern "C" {

int64_t mwx_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                            uint64_t cap) {
  Output out{dst, 0, size_t(cap), false};
  return decode_all(src, size_t(n), out);
}

int64_t mwx_zstd_decompress_alloc(const uint8_t* src, uint64_t n,
                                  uint8_t** result) {
  Output out{nullptr, 0, 0, true};
  const int64_t rc = decode_all(src, size_t(n), out);
  if (rc < 0) {
    std::free(out.data);
    out.data = nullptr;
  }
  *result = out.data;
  return rc;
}

void mwx_zstd_free(uint8_t* p) { std::free(p); }

const char* mwx_zstd_error(int64_t code) { return error_message(code); }

uint32_t mwx_crc32c(const uint8_t* p, uint64_t n) {
  static const CrcTables tables;  // built once; thread-safe initialisation
  const auto& t = tables.t;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    const uint32_t lo = c ^ uint32_t(load_le(p, 4));
    const uint32_t hi = uint32_t(load_le(p + 4, 4));
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
