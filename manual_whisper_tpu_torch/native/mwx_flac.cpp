// mwx_flac — native FLAC decoder of manual_whisper_tpu_torch (a copy of
// manual_whisper_tpu/native/mwx_flac.cpp, same C ABI; linked into the same
// library as mwx_audio.cpp).
//
// Role parity: the reference decodes compressed containers through ffmpeg
// (whisperx.load_audio, reference: transcribe.py:117; format list
// README.md:90).  ffmpeg is absent on some deploy hosts, so the one
// lossless compressed format in that list is owned natively here:
// a from-scratch FLAC stream decoder (subset and full-spec subframes:
// constant / verbatim / fixed 0-4 / LPC up to order 32, Rice and Rice2
// residual partitions with raw-bits escapes, left/right/mid-side stereo
// decorrelation, UTF-8 frame numbers, wasted bits).  Output is mono
// float32 like the WAV path in mwx_audio.cpp.
//
// C ABI only; bound from Python with ctypes (audio/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// MSB-first bit reader over an in-memory buffer.
struct BitReader {
  const uint8_t* data;
  uint64_t len;      // bytes
  uint64_t bitpos;   // absolute bit position
  bool overrun;

  BitReader(const uint8_t* d, uint64_t n) : data(d), len(n), bitpos(0),
                                            overrun(false) {}

  bool eof() const { return bitpos >= len * 8; }

  uint32_t bits(int n) {  // n <= 32
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (bitpos >= len * 8) { overrun = true; return 0; }
      uint64_t byte = bitpos >> 3;
      int off = 7 - (int)(bitpos & 7);
      v = (v << 1) | ((data[byte] >> off) & 1u);
      ++bitpos;
    }
    return v;
  }

  uint64_t bits64(int n) {  // n <= 64
    uint64_t v = 0;
    if (n > 32) { v = bits(n - 32); n = 32; }
    return (v << n) | bits(n);
  }

  int32_t sbits(int n) {  // signed two's complement
    uint32_t v = bits(n);
    if (n > 0 && n < 32 && (v & (1u << (n - 1)))) {
      v |= ~((1u << n) - 1u);
    }
    return (int32_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!overrun && bits(1) == 0) {
      ++q;
      if (q > 1u << 24) { overrun = true; break; }  // corrupt stream guard
    }
    return q;
  }

  void align_byte() { bitpos = (bitpos + 7) & ~(uint64_t)7; }
};

// UTF-8-style coded number used for frame/sample indices (up to 36 bits).
bool read_utf8_u64(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.bits(8);
  if (br.overrun) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0x00) { v = b0; extra = 0; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = br.bits(8);
    if (br.overrun || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Rice / Rice2 residual partitions into res[0..n_res).
bool read_residual(BitReader& br, int predictor_order, uint32_t block_size,
                   int32_t* res) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t part_order = br.bits(4);
  uint32_t n_parts = 1u << part_order;
  if (block_size % n_parts != 0) return false;
  uint32_t part_len = block_size >> part_order;
  if (part_len <= (uint32_t)predictor_order && part_order > 0 &&
      part_len == 0) {
    return false;
  }
  uint32_t idx = 0;
  for (uint32_t p = 0; p < n_parts; ++p) {
    uint32_t count = part_len - (p == 0 ? (uint32_t)predictor_order : 0);
    if (p == 0 && part_len < (uint32_t)predictor_order) return false;
    uint32_t param = br.bits(param_bits);
    if (param == escape) {
      uint32_t raw_bits = br.bits(5);
      for (uint32_t i = 0; i < count; ++i) {
        res[idx++] = raw_bits ? br.sbits((int)raw_bits) : 0;
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.unary();
        uint32_t r = param ? br.bits((int)param) : 0;
        uint32_t u = (q << param) | r;
        res[idx++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);  // un-zigzag
      }
    }
    if (br.overrun) return false;
  }
  return idx == block_size - (uint32_t)predictor_order;
}

// One subframe -> block_size samples (int32, channel-local bit depth).
bool read_subframe(BitReader& br, uint32_t block_size, int bps,
                   int64_t* out) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1) == 1) wasted = 1 + (int)br.unary();
  int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 32) return false;

  std::vector<int32_t> res;
  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(ebps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) out[i] = br.sbits(ebps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED 0-4
    int order = (int)(type & 0x07);
    if ((uint32_t)order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    res.resize(block_size - order);
    if (!read_residual(br, order, block_size, res.data())) return false;
    // Wrapping (unsigned) arithmetic: valid streams stay far inside
    // int64, but crafted residuals can blow up the higher-order
    // recurrences (order 4 grows ~n^3) — wraparound keeps that defined.
    for (uint32_t i = order; i < block_size; ++i) {
      uint64_t r = (uint64_t)(int64_t)res[i - order];
      uint64_t a = i >= 1 ? (uint64_t)out[i - 1] : 0;
      uint64_t b = i >= 2 ? (uint64_t)out[i - 2] : 0;
      uint64_t c = i >= 3 ? (uint64_t)out[i - 3] : 0;
      uint64_t d = i >= 4 ? (uint64_t)out[i - 4] : 0;
      uint64_t p;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = a; break;
        case 2: p = 2 * a - b; break;
        case 3: p = 3 * a - 3 * b + c; break;
        default: p = 4 * a - 6 * b + 4 * c - d;
      }
      out[i] = (int64_t)(r + p);
    }
  } else if (type & 0x20) {  // LPC, order 1..32
    int order = (int)(type & 0x1F) + 1;
    if ((uint32_t)order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    uint32_t prec = br.bits(4);
    if (prec == 0xF) return false;
    int coeff_bits = (int)prec + 1;
    int shift = br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(coeff_bits);
    res.resize(block_size - order);
    if (!read_residual(br, order, block_size, res.data())) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      // Wrapping (unsigned) accumulate: spec-valid streams never
      // overflow int64 here, but crafted coefficient/sample garbage
      // can — wraparound keeps that defined (garbage in, garbage out;
      // UBSan-clean under the mutation fuzzer).
      uint64_t acc = 0;
      for (int k = 0; k < order; ++k) {
        acc += (uint64_t)coef[k] * (uint64_t)out[i - 1 - k];
      }
      out[i] = (int64_t)((uint64_t)res[i - order] +
                         (uint64_t)((int64_t)acc >> shift));
    }
  } else {
    return false;  // reserved type
  }
  if (br.overrun) return false;
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) {
      out[i] = (int64_t)((uint64_t)out[i] << wasted);
    }
  }
  return true;
}

const uint32_t kBlockSizeTable[16] = {
    0, 192, 576, 1152, 2304, 4608, 0, 0,
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

const uint32_t kSampleRateTable[12] = {
    0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
    32000, 44100, 48000, 96000};

}  // namespace

extern "C" {

void mwx_free(void* p);  // defined in mwx_audio.cpp (same .so)

// Decode a FLAC stream to mono float32.
// Returns 0 on success; *out is malloc'd (caller frees with mwx_free).
// Error codes: -1 bad magic / no STREAMINFO, -2 malformed frame,
// -3 unsupported layout, -4 alloc failure, -5 stream too large
// (output cap, anti-DoS).
int mwx_decode_flac(const uint8_t* data, uint64_t len, float** out,
                    int64_t* out_len, int32_t* sample_rate) {
  if (!data || len < 8 || std::memcmp(data, "fLaC", 4) != 0) return -1;

  BitReader br(data, len);
  br.bitpos = 32;

  // Metadata blocks; STREAMINFO must come first.
  uint32_t si_sr = 0, si_channels = 0, si_bps = 0;
  uint64_t si_total = 0;
  bool have_streaminfo = false;
  bool last = false;
  while (!last) {
    last = br.bits(1) == 1;
    uint32_t btype = br.bits(7);
    uint32_t blen = br.bits(24);
    if (br.overrun) return -1;
    if (btype == 0 && blen >= 34) {  // STREAMINFO
      br.bits(16);  // min block size
      br.bits(16);  // max block size
      br.bits(24);  // min frame size
      br.bits(24);  // max frame size
      si_sr = br.bits(20);
      si_channels = br.bits(3) + 1;
      si_bps = br.bits(5) + 1;
      si_total = br.bits64(36);
      br.bitpos += 128;            // MD5
      br.bitpos += (uint64_t)(blen - 34) * 8;
      have_streaminfo = true;
    } else {
      br.bitpos += (uint64_t)blen * 8;
    }
    if (br.bitpos > len * 8) return -1;
  }
  if (!have_streaminfo || si_sr == 0 || si_channels == 0 ||
      si_channels > 8 || si_bps == 0 || si_bps > 32) {
    return -1;
  }

  // Output cap: FLAC constant-blocks expand almost without bound (a
  // ~15-byte silent block decodes to 65535 samples), and STREAMINFO's
  // 36-bit total is attacker-controlled — a crafted header must not
  // drive a huge allocation (found by the ASan mutation fuzzer).
  // 500M mono samples ≈ 8.7 h @ 16 kHz ≈ 2 GB of output: far above any
  // legitimate meeting recording, far below address-space games.
  const uint64_t kMaxTotalSamples = 500ull * 1000 * 1000;
  if (si_total > kMaxTotalSamples) return -5;

  std::vector<float> mono;
  if (si_total) mono.reserve((size_t)std::min<uint64_t>(si_total, 1u << 24));
  std::vector<std::vector<int64_t>> ch(si_channels);

  // Frame loop.
  while (!br.eof()) {
    // Tolerate trailing byte-aligned padding/garbage shorter than a header.
    if ((len * 8 - br.bitpos) < 32) break;
    uint32_t sync = br.bits(14);
    if (sync != 0x3FFE) {
      // Streaming encoders write total_samples=0; without it there is
      // no early break above, so trailing tag/padding bytes after the
      // last frame land here.  Keep what decoded (like ffmpeg) rather
      // than failing a fully-decoded stream; an unsynced FIRST frame is
      // still a hard error.
      if (!mono.empty()) break;
      return -2;
    }
    if (br.bits(1) != 0) return -2;   // reserved
    br.bits(1);                       // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    if (br.bits(1) != 0) return -2;   // reserved
    uint64_t frame_no;
    if (!read_utf8_u64(br, &frame_no)) return -2;

    uint32_t block_size;
    if (bs_code == 0) return -2;
    else if (bs_code == 6) block_size = br.bits(8) + 1;
    else if (bs_code == 7) block_size = br.bits(16) + 1;
    else block_size = kBlockSizeTable[bs_code];

    // Per-frame sample-rate field: the bits must be consumed, but the
    // stream-level rate (STREAMINFO) is authoritative for the output.
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return -2;

    int bps = (int)si_bps;
    switch (ss_code) {
      case 0: break;                 // from STREAMINFO
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -2;
    }
    br.bits(8);  // CRC-8 of header (not verified; structure is validated)
    if (br.overrun) return -2;

    uint32_t n_ch;
    int decorrelate = 0;  // 0 none, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code < 8) {
      n_ch = ch_code + 1;
    } else if (ch_code <= 10) {
      n_ch = 2;
      decorrelate = (int)ch_code - 7;
    } else {
      return -3;
    }
    if (n_ch != si_channels) return -3;

    for (uint32_t c = 0; c < n_ch; ++c) {
      if (ch[c].size() < block_size) ch[c].resize(block_size);
      int sub_bps = bps;
      // The "side" channel carries one extra bit.
      if ((decorrelate == 1 && c == 1) || (decorrelate == 2 && c == 0) ||
          (decorrelate == 3 && c == 1)) {
        sub_bps += 1;
      }
      if (!read_subframe(br, block_size, sub_bps, ch[c].data())) return -2;
    }
    br.align_byte();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.overrun) return -2;

    if (mono.size() + block_size > kMaxTotalSamples) return -5;

    // Undo stereo decorrelation, then mix to mono in float.
    double scale = 1.0 / (double)(1ull << (bps - 1));
    for (uint32_t i = 0; i < block_size; ++i) {
      int64_t l, r;
      double v;
      switch (decorrelate) {
        case 1:  // left/side: right = left - side
          l = ch[0][i];
          r = (int64_t)((uint64_t)l - (uint64_t)ch[1][i]);
          v = 0.5 * ((double)l + (double)r);
          break;
        case 2:  // right/side: left = right + side
          r = ch[1][i];
          l = (int64_t)((uint64_t)r + (uint64_t)ch[0][i]);
          v = 0.5 * ((double)l + (double)r);
          break;
        case 3: {  // mid/side
          int64_t mid = ch[0][i], side = ch[1][i];
          l = (int64_t)((((uint64_t)mid << 1) | ((uint64_t)side & 1)) +
                        (uint64_t)side);
          l >>= 1;
          r = (int64_t)((uint64_t)l - (uint64_t)side);
          v = 0.5 * ((double)l + (double)r);
          break;
        }
        default: {
          double acc = 0.0;
          for (uint32_t c = 0; c < n_ch; ++c) acc += (double)ch[c][i];
          v = acc / (double)n_ch;
        }
      }
      mono.push_back((float)(v * scale));
    }
    if (si_total && mono.size() >= si_total) break;
  }

  if (si_total && mono.size() > si_total) mono.resize((size_t)si_total);
  float* buf = (float*)std::malloc(sizeof(float) *
                                   (mono.empty() ? 1 : mono.size()));
  if (!buf) return -4;
  if (!mono.empty()) {
    std::memcpy(buf, mono.data(), sizeof(float) * mono.size());
  }
  *out = buf;
  *out_len = (int64_t)mono.size();
  *sample_rate = (int32_t)si_sr;
  return 0;
}

}  // extern "C"
