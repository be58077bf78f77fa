// Native FLAC encoder — VERBATIM subframes only (C ABI via ctypes,
// semi_supervised_asr_tpu_torch/utils/flac.py::write_flac_verbatim; the
// PyTorch port's copy of semi_supervised_asr_tpu/native/flac_encoder.cpp).
//
// Purpose: corpus fabrication (tests write LibriSpeech-shaped FLAC trees
// with it).  VERBATIM frames are byte-aligned end to end, so encoding is a
// header + big-endian memcpy + CRCs: this encoder runs at memory speed and
// stays ~200 lines.
//
// VERBATIM means no compression (file size == PCM size + ~0.1% framing),
// which is exactly right for fabricated corpora: the point is to exercise
// the real FLAC container path (decoder, STREAMINFO length probes,
// manifest scans) at scale, not to save disk.
//
// Stream layout produced (spec: RFC 9639; mirrors what the test fixture
// emits and the native decoder consumes):
//   "fLaC" magic
//   STREAMINFO (last-metadata flag set): min/max blocksize, rates, total
//   frames: sync(14) 0 0 | bs_code=7 sr_code=0 | chan=0 ss=0 0 |
//           utf8(frame#) | (blocksize-1):16 | crc8(header) |
//           0x02 VERBATIM subframe | samples BE16 | crc16(frame)
// bs_code 7 ("16 bit from header") keeps every frame's layout identical
// regardless of the final partial block.  Mono 16-bit only — that is the
// LibriSpeech shape and the only shape the fabricators emit.

#include <cstdint>
#include <cstring>

namespace {

uint8_t crc8_update(uint8_t c, uint8_t b) {
  c ^= b;
  for (int i = 0; i < 8; ++i)
    c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  return c;
}

uint16_t crc16_update(uint16_t c, uint8_t b) {
  c ^= (uint16_t)b << 8;
  for (int i = 0; i < 8; ++i)
    c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  return c;
}

struct Tables {
  uint8_t t8[256];
  uint16_t t16[256];
  Tables() {
    for (int i = 0; i < 256; ++i) {
      t8[i] = crc8_update(0, (uint8_t)i);
      t16[i] = crc16_update(0, (uint8_t)i);
    }
  }
};
const Tables kTables;

uint8_t crc8(const uint8_t* p, int64_t n) {
  uint8_t c = 0;
  for (int64_t i = 0; i < n; ++i) c = kTables.t8[c ^ p[i]];
  return c;
}

uint16_t crc16(const uint8_t* p, int64_t n) {
  uint16_t c = 0;
  for (int64_t i = 0; i < n; ++i)
    c = (uint16_t)((c << 8) ^ kTables.t16[(c >> 8) ^ p[i]]);
  return c;
}

// FLAC's UTF-8-style frame-number coding (frame numbers, not codepoints).
int utf8_number(uint64_t v, uint8_t* out) {
  if (v < 0x80) {
    out[0] = (uint8_t)v;
    return 1;
  }
  static const uint8_t lead[] = {0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE};
  for (int follow = 1; follow <= 6; ++follow) {
    if (v < (1ULL << (5 * follow + 6)) || follow == 6) {
      out[0] = (uint8_t)(lead[follow - 1] | (v >> (6 * follow)));
      for (int i = 0; i < follow; ++i)
        out[1 + i] = (uint8_t)(0x80 | ((v >> (6 * (follow - 1 - i))) & 0x3F));
      return 1 + follow;
    }
  }
  return 0;  // unreachable
}

void put_be(uint8_t* p, uint64_t v, int bytes) {
  for (int i = 0; i < bytes; ++i)
    p[i] = (uint8_t)(v >> (8 * (bytes - 1 - i)));
}

}  // namespace

extern "C" {

// Size an output buffer for flac_encode_verbatim (exact upper bound).
int64_t flac_encode_verbatim_bound(int64_t n, int32_t blocksize) {
  if (blocksize <= 0) blocksize = 4096;
  int64_t frames = (n + blocksize - 1) / blocksize;
  if (frames == 0) frames = 1;
  // per frame: 4 hdr + <=7 utf8 + 2 bs + 1 crc8 + 1 subhdr + 2n + 2 crc16
  return 4 + 4 + 34 + frames * 17 + 2 * n;
}

// Encode mono 16-bit samples into a FLAC stream.  Returns bytes written,
// or -1 if the output buffer is too small / arguments invalid.
int64_t flac_encode_verbatim(const int16_t* samples, int64_t n,
                             int32_t sample_rate, int32_t blocksize,
                             uint8_t* out, int64_t cap) {
  if (n < 0 || sample_rate <= 0 || sample_rate >= (1 << 20)) return -1;
  // STREAMINFO packs total samples into a 36-bit field; a larger n
  // would silently corrupt the bps/sample-rate bits of the header
  if ((uint64_t)n >= (1ULL << 36)) return -1;
  if (blocksize <= 0) blocksize = 4096;
  if (blocksize < 16 || blocksize > 65535) return -1;
  if (cap < flac_encode_verbatim_bound(n, blocksize)) return -1;

  uint8_t* p = out;
  std::memcpy(p, "fLaC", 4);
  p += 4;

  // STREAMINFO, last-metadata-block flag set.
  uint8_t* si = p;
  si[0] = 0x80;  // last | type 0
  put_be(si + 1, 34, 3);
  uint8_t* b = si + 4;
  std::memset(b, 0, 34);
  put_be(b + 0, (uint64_t)blocksize, 2);  // min blocksize
  put_be(b + 2, (uint64_t)blocksize, 2);  // max blocksize
  // min/max framesize (3+3 bytes): 0 = unknown
  // sample_rate:20 | (channels-1):3 | (bps-1):5 | total:36  == 8 bytes
  uint64_t tail = ((uint64_t)sample_rate << 44) | (0ULL << 41) |
                  ((uint64_t)(16 - 1) << 36) | (uint64_t)n;
  put_be(b + 10, tail, 8);
  // MD5 (16 bytes) stays 0 = unset.
  p = si + 4 + 34;

  // n == 0 emits a frameless stream (magic + STREAMINFO), which is valid.
  for (int64_t start = 0, fno = 0; start < n; start += blocksize, ++fno) {
    int64_t blk = n - start < blocksize ? n - start : blocksize;
    uint8_t* hdr = p;
    hdr[0] = 0xFF;
    hdr[1] = 0xF8;          // sync 11111111 111110, reserved 0, fixed-bs 0
    hdr[2] = 0x70;          // bs_code 7 (16 bit at end), sr from STREAMINFO
    hdr[3] = 0x00;          // mono, ss from STREAMINFO, reserved 0
    int hn = 4 + utf8_number((uint64_t)fno, hdr + 4);
    put_be(hdr + hn, (uint64_t)(blk - 1), 2);
    hn += 2;
    hdr[hn] = crc8(hdr, hn);
    hn += 1;
    hdr[hn] = 0x02;         // subframe: VERBATIM, no wasted bits
    hn += 1;
    uint8_t* s = hdr + hn;
    for (int64_t i = 0; i < blk; ++i) {
      uint16_t v = (uint16_t)samples[start + i];
      s[2 * i] = (uint8_t)(v >> 8);
      s[2 * i + 1] = (uint8_t)v;
    }
    int64_t flen = hn + 2 * blk;
    put_be(hdr + flen, crc16(hdr, flen), 2);
    p = hdr + flen + 2;
  }
  return p - out;
}

}  // extern "C"
