// Native FLAC decoder (C ABI, bound via ctypes — see utils/flac.py).
//
// LibriSpeech distributes audio as 16-bit FLAC; soundfile/ffmpeg/libFLAC
// are not dependencies, so the framework carries its own decoder
// (SURVEY.md §3 #2: LibriSpeech preprocessing).  Implements the full FLAC
// bitstream subset needed for real-world files: STREAMINFO parsing,
// frame headers (all block-size/sample-rate/sample-size codes, UTF-8
// frame numbers), CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
// Rice + Rice2 partitioned residuals with escape partitions, wasted bits,
// and all four channel assignments (independent, left/side, right/side,
// mid/side).  Frame CRCs are consumed but not verified (decode speed; the
// container is read off trusted local disk).
//
// Reference: the FLAC format spec (RFC 9639).  No code copied from any
// implementation.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t n;        // total bytes
  int64_t byte = 0; // next byte index
  int bit = 0;      // bits consumed of current byte (0..7)
  bool fail = false;

  BitReader(const uint8_t* d, int64_t len) : data(d), n(len) {}

  bool eof() const { return byte >= n; }

  // Read `bits` (0..57) as an unsigned value, MSB-first.
  uint64_t read(int bits) {
    uint64_t v = 0;
    while (bits > 0) {
      if (byte >= n) { fail = true; return 0; }
      int avail = 8 - bit;
      int take = bits < avail ? bits : avail;
      int shift = avail - take;
      uint64_t chunk = (uint64_t)((data[byte] >> shift) & ((1u << take) - 1));
      v = (v << take) | chunk;
      bit += take;
      bits -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
    return v;
  }

  // Signed two's-complement read.
  int64_t read_signed(int bits) {
    uint64_t v = read(bits);
    if (bits == 0) return 0;
    uint64_t sign = 1ull << (bits - 1);
    return (v & sign) ? (int64_t)(v - (sign << 1)) : (int64_t)v;
  }

  // Count consecutive 0 bits, consume the terminating 1.  (FLAC unary.)
  uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if (byte >= n) { fail = true; return 0; }
      if (read(1)) return q;
      ++q;
      if (q > 1u << 24) { fail = true; return 0; }  // corrupt stream guard
    }
  }

  void align() {
    if (bit != 0) { bit = 0; ++byte; }
  }

  void skip_bytes(int64_t k) {
    byte += k;
    if (byte > n) fail = true;
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits = 0;
  uint64_t total_samples = 0;
  uint32_t max_blocksize = 0;
};

// Parse "fLaC" + metadata blocks; leave `br` at the first audio frame.
bool parse_header(BitReader& br, StreamInfo& si) {
  if (br.n < 4 || std::memcmp(br.data, "fLaC", 4) != 0) return false;
  br.skip_bytes(4);
  bool last = false;
  bool have_si = false;
  while (!last) {
    if (br.fail || br.eof()) return false;
    last = br.read(1);
    uint32_t type = (uint32_t)br.read(7);
    uint32_t len = (uint32_t)br.read(24);
    if (type == 0) {  // STREAMINFO
      if (len != 34) return false;
      br.read(16);                                  // min blocksize
      si.max_blocksize = (uint32_t)br.read(16);
      br.read(24); br.read(24);                     // min/max framesize
      si.sample_rate = (uint32_t)br.read(20);
      si.channels = (uint32_t)br.read(3) + 1;
      si.bits = (uint32_t)br.read(5) + 1;
      si.total_samples = br.read(36);
      br.skip_bytes(16);                            // MD5
      have_si = true;
    } else {
      br.skip_bytes(len);
    }
  }
  return have_si && !br.fail;
}

// FLAC's extended UTF-8 number (frame/sample index), up to 36 bits.
bool read_utf8(BitReader& br, uint64_t& out) {
  uint32_t b0 = (uint32_t)br.read(8);
  if (br.fail) return false;
  int follow;
  uint64_t v;
  if ((b0 & 0x80) == 0)        { out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { follow = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { follow = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { follow = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { follow = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { follow = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE)          { follow = 6; v = 0; }
  else return false;
  for (int i = 0; i < follow; ++i) {
    uint32_t b = (uint32_t)br.read(8);
    if (br.fail || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  out = v;
  return true;
}

// Partitioned Rice residual into res[order..blocksize).
bool read_residual(BitReader& br, int blocksize, int order,
                   std::vector<int64_t>& res) {
  uint32_t method = (uint32_t)br.read(2);
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = (uint32_t)br.read(4);
  uint32_t nparts = 1u << porder;
  if (blocksize % nparts != 0) return false;
  int psize = blocksize >> porder;
  if (psize <= order && nparts == 1) return false;
  int idx = order;
  for (uint32_t p = 0; p < nparts; ++p) {
    int count = psize - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.read(pbits);
    if (param == escape) {
      uint32_t raw = (uint32_t)br.read(5);
      for (int i = 0; i < count; ++i)
        res[idx++] = raw ? br.read_signed((int)raw) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t lo = param ? br.read((int)param) : 0;
        uint64_t u = ((uint64_t)q << param) | lo;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // unzigzag
      }
    }
    if (br.fail) return false;
  }
  return idx == blocksize;
}

// One subframe into out[0..blocksize), at effective bit depth `bps`.
bool read_subframe(BitReader& br, int blocksize, int bps,
                   std::vector<int64_t>& out) {
  if (br.read(1) != 0) return false;  // reserved
  uint32_t type = (uint32_t)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = (int)br.read_unary() + 1;
  bps -= wasted;
  if (bps <= 0 || br.fail) return false;

  if (type == 0) {                       // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {                // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!read_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = out[i - 1]; break;
        case 2: pred = 2 * out[i - 1] - out[i - 2]; break;
        case 3: pred = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: pred = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                       - out[i - 4]; break;
      }
      out[i] += pred;
    }
  } else if (type & 0x20) {              // LPC
    int order = (int)(type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    uint32_t prec = (uint32_t)br.read(4);
    if (prec == 0xF) return false;       // invalid per spec
    int precision = (int)prec + 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!read_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return !br.fail;
}

// Decode one frame; append interleaved samples.  Returns blocksize or -1.
int decode_frame(BitReader& br, const StreamInfo& si, int32_t* out,
                 int64_t capacity, int64_t written) {
  // Frame header.
  if (br.read(14) != 0x3FFE) return -1;  // sync
  br.read(1);                            // reserved
  br.read(1);                            // blocking strategy
  uint32_t bs_code = (uint32_t)br.read(4);
  uint32_t sr_code = (uint32_t)br.read(4);
  uint32_t ch_code = (uint32_t)br.read(4);
  uint32_t ss_code = (uint32_t)br.read(3);
  br.read(1);                            // reserved
  uint64_t frame_no;
  if (!read_utf8(br, frame_no)) return -1;

  int blocksize;
  switch (bs_code) {
    case 0: return -1;
    case 1: blocksize = 192; break;
    case 6: blocksize = (int)br.read(8) + 1; break;
    case 7: blocksize = (int)br.read(16) + 1; break;
    default:
      blocksize = bs_code <= 5 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
  }
  if (sr_code == 12) br.read(8);         // sample rate in header: skip
  else if (sr_code == 13 || sr_code == 14) br.read(16);
  br.read(8);                            // header CRC-8 (not verified)

  int bps;
  switch (ss_code) {
    case 0: bps = (int)si.bits; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }

  int channels = ch_code < 8 ? (int)ch_code + 1 : 2;
  if (channels != (int)si.channels) return -1;
  if (br.fail || blocksize <= 0) return -1;
  if (written + (int64_t)blocksize * channels > capacity) return -1;

  static thread_local std::vector<std::vector<int64_t>> chan;
  chan.resize(channels);
  for (int c = 0; c < channels; ++c) {
    chan[c].assign(blocksize, 0);
    int sub_bps = bps;
    // side channels carry one extra bit
    if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
        (ch_code == 10 && c == 1))
      sub_bps += 1;
    if (!read_subframe(br, blocksize, sub_bps, chan[c])) return -1;
  }

  // Stereo decorrelation.
  if (ch_code == 8) {                    // left/side
    for (int i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
  } else if (ch_code == 9) {             // side/right
    for (int i = 0; i < blocksize; ++i) chan[0][i] += chan[1][i];
  } else if (ch_code == 10) {            // mid/side
    for (int i = 0; i < blocksize; ++i) {
      int64_t mid = chan[0][i], side = chan[1][i];
      mid = (mid << 1) | (side & 1);
      chan[0][i] = (mid + side) >> 1;
      chan[1][i] = (mid - side) >> 1;
    }
  }

  br.align();
  br.read(16);                           // frame CRC-16 (not verified)
  if (br.fail) return -1;

  for (int i = 0; i < blocksize; ++i)
    for (int c = 0; c < channels; ++c)
      out[written + (int64_t)i * channels + c] = (int32_t)chan[c][i];
  return blocksize;
}

}  // namespace

extern "C" {

// Parse STREAMINFO.  info = [total_samples, sample_rate, channels, bits].
// Returns 0 on success, negative on malformed input.
int flac_stream_info(const uint8_t* data, int64_t n, int64_t* info) {
  BitReader br(data, n);
  StreamInfo si;
  if (!parse_header(br, si)) return -1;
  info[0] = (int64_t)si.total_samples;
  info[1] = si.sample_rate;
  info[2] = si.channels;
  info[3] = si.bits;
  return 0;
}

// Decode the whole stream into `out` (interleaved int32, capacity in
// samples).  Returns samples-per-channel decoded, or negative on error.
int64_t flac_decode_all(const uint8_t* data, int64_t n, int32_t* out,
                        int64_t capacity) {
  BitReader br(data, n);
  StreamInfo si;
  if (!parse_header(br, si)) return -1;
  int64_t per_channel = 0;
  int64_t written = 0;
  while (!br.eof() && !br.fail) {
    // allow (and stop at) trailing padding: peek for a plausible sync
    if (br.byte + 2 > br.n) break;
    int got = decode_frame(br, si, out, capacity, written);
    if (got < 0) return per_channel > 0 ? -3 : -2;
    written += (int64_t)got * si.channels;
    per_channel += got;
    if (si.total_samples && per_channel >= (int64_t)si.total_samples) break;
  }
  if (br.fail) return -4;
  return per_channel;
}

}  // extern "C"
