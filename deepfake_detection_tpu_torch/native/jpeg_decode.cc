// JPEG decode (bytes or file -> RGB8) with no libjpeg: the port's host-side
// decoder for the input pipeline, the scoring front end and the streams.
//
// Its output is byte for byte what libjpeg-turbo (x86-64, SIMD on) gives
// under the settings the JAX package's native pool decodes with:
// scale 1, JDCT_ISLOW, out_color_space JCS_RGB, fancy upsampling.  So it
// follows libjpeg-turbo's decoder step by step:
//
//   * markers as jdmarker.c reads them (a missing EOF reads as EOI, like
//     jpeg_mem_src; junk between markers is skipped; DHT/DQT/DRI/DAC/APPn/
//     COM between scans; missing Huffman tables 0 and 1 are the standard
//     ones, as Motion-JPEG frames expect);
//   * Huffman decode as jdhuff.c (baseline, extended) and jdphuff.c
//     (progressive) do it, with their handling of damaged data: bits past
//     a marker read as zeros, the rest of a segment stays zero once they
//     are needed, restart markers resynchronise as jpeg_resync_to_restart
//     does;
//   * the ISLOW inverse DCT in the arithmetic of libjpeg-turbo's SSE2/AVX2
//     version (16-bit dequantisation and sums, saturating packs), which is
//     the C version's wherever the data is in range;
//   * fancy upsampling (jdsample.c: h2v1, h1v2, h2v2, edges replicated) and
//     jdcolor.c's fixed-point YCbCr -> RGB.
//
// It declines (returns null with a reason) what it does not port: 4
// components, precision other than 8, arithmetic coding, lossless and
// hierarchical frames, sampling factors of 3 or 4, and a progressive stream
// whose output libjpeg would block-smooth (one that lacks refinement scans,
// as a truncated one does).  Anything libjpeg rejects is rejected too.
//
// Every read of the input goes through a bounds-checked source; the
// coefficient and sample buffers are sized from the frame header before
// any write.
//
// Pure C ABI, loaded with ctypes by data/native.py, which builds this file
// and imaging.cc into one library with the host C++ compiler at first use:
//   c++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC
//       jpeg_decode.cc imaging.cc -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/stat.h>
#include <new>
#include <stdexcept>
#include <vector>

#include "pool.h"

namespace {

// ---------------------------------------------------------------------------
// outcome codes (dfd_jpeg_reason gives their text)
// ---------------------------------------------------------------------------

enum Why {
  kOk = 0,
  kMalformed = 1,      // what libjpeg rejects
  kCmyk = 2,           // 4 components
  kComponents = 3,     // 2 or 5+ components
  kPrecision = 4,      // not 8-bit samples
  kArithmetic = 5,     // SOF9/SOF10
  kLossless = 6,       // SOF3, SOF5-7, SOF11, SOF13-15
  kSmoothing = 7,      // progressive stream libjpeg would block-smooth
  kTooLarge = 8,       // more pixels than the decoder allocates
  kIo = 9,             // file unreadable or empty
  kNoMemory = 10,
};

const char* const kReasons[] = {
    "ok",
    "malformed or truncated JPEG stream",
    "4 components (CMYK/YCCK)",
    "component count other than 1 or 3",
    "sample precision other than 8 bits",
    "arithmetic coding",
    "lossless or hierarchical JPEG",
    "progressive stream truncated (missing refinement scans)",
    "image too large",
    "file unreadable or empty",
    "out of memory",
};

struct Fail {
  int why;
};

[[noreturn]] void fail(int why) { throw Fail{why}; }

// more pixels than this (8192 x 8192) are declined, so a header cannot
// make a server allocate gigabytes (libjpeg's own limit is 65500 a side)
constexpr uint64_t kMaxPixels = uint64_t(1) << 26;

// zig-zag -> natural order, with 16 extra entries so a damaged run length
// past coefficient 63 lands on 63 (as libjpeg's jpeg_natural_order does)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the standard Huffman tables (JPEG spec K.3), used where a stream defines
// no table 0 or 1 of a class
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                   0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                   5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// markers
enum {
  M_SOF0 = 0xc0, M_SOF1 = 0xc1, M_SOF2 = 0xc2, M_SOF3 = 0xc3,
  M_DHT = 0xc4, M_SOF5 = 0xc5, M_SOF6 = 0xc6, M_SOF7 = 0xc7,
  M_JPG = 0xc8, M_SOF9 = 0xc9, M_SOF10 = 0xca, M_SOF11 = 0xcb,
  M_DAC = 0xcc, M_SOF13 = 0xcd, M_SOF14 = 0xce, M_SOF15 = 0xcf,
  M_RST0 = 0xd0, M_RST7 = 0xd7, M_SOI = 0xd8, M_EOI = 0xd9,
  M_SOS = 0xda, M_DQT = 0xdb, M_DNL = 0xdc, M_DRI = 0xdd,
  M_APP0 = 0xe0, M_APP14 = 0xee, M_APP15 = 0xef, M_COM = 0xfe,
  M_TEM = 0x01,
};

// ---------------------------------------------------------------------------
// input: the buffer, then "FF D9" forever (jpeg_mem_src's fake EOI)
// ---------------------------------------------------------------------------

struct Source {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  int byte() {
    if (pos < size) return data[pos++];
    // past the end every refill hands out the two bytes FF D9
    const size_t k = pos++ - size;
    return (k & 1) ? M_EOI : 0xff;
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    if (n > 0) pos += static_cast<size_t>(n);
  }
};

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  // lookahead: (length << 8) | symbol for codes of <= 8 bits, 9 << 8 else
  uint16_t lookup[256];
  uint8_t vals[256];
};

// jpeg_make_d_derived_tbl, with its validation
void derive(const HuffTable& t, bool is_dc, Derived* d) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = t.bits[l];
    if (p + i > 256) fail(kMalformed);
    while (i--) huffsize[p++] = static_cast<char>(l);
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (uint32_t(1) << si)) fail(kMalformed);
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      d->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xfffff;
  for (int i = 0; i < 256; ++i) d->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      int look = static_cast<int>(huffcode[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
        d->lookup[look++] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; ++i)
      if (t.vals[i] > 15) fail(kMalformed);
  }
  std::memcpy(d->vals, t.vals, 256);
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int wib = 0, hib = 0;        // width/height in blocks (real)
  int bw = 0, bh = 0;          // allocated blocks (MCU-padded)
  int dsw = 0, dsh = 0;        // downsampled width/height in samples
  bool latched = false;
  uint16_t quant[64] = {};     // natural order, latched at its first scan
  std::vector<int16_t> coef;   // bw*bh blocks of 64
  int coef_bits[64];           // progressive: Al of each coefficient, -1
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) { src_.data = data; src_.size = size; }
  uint8_t* run(int* out_w, int* out_h);

 private:
  // markers (jdmarker.c)
  void first_marker();
  void next_marker();
  int read_markers();  // returns M_SOS or M_EOI
  void get_sof(bool progressive);
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_dac();
  void get_app();
  void skip_variable();
  bool read_restart_marker();
  void initial_setup();

  // bits (jdhuff.c)
  void fill(int nbits);
  int get_bits(int n) {
    if (bits_ < n) fill(n);
    bits_ -= n;
    return static_cast<int>((buf_ >> bits_) & ((uint64_t(1) << n) - 1));
  }
  int decode(const Derived& d);
  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + static_cast<int>((~0u << s) + 1) : r;
  }

  // scans
  void decode_scan();
  void process_restart();
  void mcu_sequential(int16_t** blocks);
  void mcu_dc_first(int16_t** blocks);
  void mcu_ac_first(int16_t* block);
  void mcu_dc_refine(int16_t** blocks);
  void mcu_ac_refine(int16_t* block);

  // output
  void inverse_dct();
  uint8_t* color_convert(int* out_w, int* out_h);

  Source src_;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool progressive_ = false;
  bool multi_scan_ = false;
  int precision_ = 8, width_ = 0, height_ = 0;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  int max_h_ = 1, max_v_ = 1;
  int mcus_per_row_ = 0, mcu_rows_ = 0;
  HuffTable dc_tables_[4], ac_tables_[4];
  bool quant_defined_[4] = {};
  uint16_t quant_[4][64] = {};
  void fill_std_tables();
  // current scan
  int comps_in_scan_ = 0;
  Component* scan_comps_[4] = {};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int next_restart_num_ = 0;
  Derived dc_derived_[4], ac_derived_[4];
  int last_dc_[4] = {};
  unsigned eobrun_ = 0;
  int restarts_to_go_ = 0;
  bool insufficient_ = false;
  uint64_t buf_ = 0;
  int bits_ = 0;
};

// -- markers ----------------------------------------------------------------

void Decoder::first_marker() {
  const int c = src_.byte();
  const int c2 = src_.byte();
  if (c != 0xff || c2 != M_SOI) fail(kMalformed);
  unread_marker_ = c2;
}

void Decoder::next_marker() {
  int c;
  for (;;) {
    c = src_.byte();
    while (c != 0xff) c = src_.byte();
    do {
      c = src_.byte();
    } while (c == 0xff);
    if (c != 0) break;  // FF 00 is stuffed data: keep looking
  }
  unread_marker_ = c;
}

int Decoder::read_markers() {
  for (;;) {
    if (unread_marker_ == 0) {
      if (!saw_soi_)
        first_marker();
      else
        next_marker();
    }
    const int m = unread_marker_;
    switch (m) {
      case M_SOI:
        if (saw_soi_) fail(kMalformed);
        restart_interval_ = 0;
        saw_jfif_ = saw_adobe_ = false;
        adobe_transform_ = 0;
        saw_soi_ = true;
        break;
      case M_SOF0:
      case M_SOF1:
        get_sof(false);
        break;
      case M_SOF2:
        get_sof(true);
        break;
      case M_SOF9:
      case M_SOF10:
        fail(kArithmetic);
      case M_SOF3:
      case M_SOF5:
      case M_SOF6:
      case M_SOF7:
      case M_JPG:
      case M_SOF11:
      case M_SOF13:
      case M_SOF14:
      case M_SOF15:
        fail(kLossless);
      case M_SOS:
        get_sos();
        unread_marker_ = 0;
        return M_SOS;
      case M_EOI:
        unread_marker_ = 0;
        return M_EOI;
      case M_DAC:
        get_dac();
        break;
      case M_DHT:
        get_dht();
        break;
      case M_DQT:
        get_dqt();
        break;
      case M_DRI:
        get_dri();
        break;
      case M_DNL:
        skip_variable();
        break;
      case M_COM:
        skip_variable();
        break;
      case M_TEM:
        break;
      default:
        if (m >= M_RST0 && m <= M_RST7) break;        // parameterless
        if (m >= M_APP0 && m <= M_APP15) {
          if (m == M_APP0 || m == M_APP14)
            get_app();
          else
            skip_variable();
          break;
        }
        fail(kMalformed);
    }
    unread_marker_ = 0;
  }
}

void Decoder::get_sof(bool progressive) {
  progressive_ = progressive;
  long length = src_.u16();
  precision_ = src_.byte();
  height_ = src_.u16();
  width_ = src_.u16();
  const int n = src_.byte();
  length -= 8;
  if (saw_sof_) fail(kMalformed);
  if (height_ <= 0 || width_ <= 0 || n <= 0) fail(kMalformed);
  if (length != n * 3) fail(kMalformed);
  comps_.assign(n, Component());
  for (int ci = 0; ci < n; ++ci) {
    Component& c = comps_[ci];
    c.id = src_.byte();
    const int f = src_.byte();
    c.h = (f >> 4) & 15;
    c.v = f & 15;
    c.tq = src_.byte();
  }
  saw_sof_ = true;
}

void Decoder::get_sos() {
  if (!saw_sof_) fail(kMalformed);
  const long length = src_.u16();
  const int n = src_.byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) fail(kMalformed);
  comps_in_scan_ = n;
  Component* cur[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < n; ++i) {
    const int cc = src_.byte();
    const int c = src_.byte();
    Component* found = nullptr;
    const int limit = static_cast<int>(comps_.size()) < 4
                          ? static_cast<int>(comps_.size()) : 4;
    // libjpeg skips a component slot whose scan slot (same index) is taken
    for (int ci = 0; ci < limit; ++ci) {
      if (cc == comps_[ci].id && !cur[ci]) {
        found = &comps_[ci];
        break;
      }
    }
    if (!found) fail(kMalformed);
    cur[i] = found;
    found->dc_tbl = (c >> 4) & 15;
    found->ac_tbl = c & 15;
    for (int pi = 0; pi < i; ++pi)
      if (cur[pi] == found) fail(kMalformed);
  }
  for (int i = 0; i < 4; ++i) scan_comps_[i] = cur[i];
  ss_ = src_.byte();
  se_ = src_.byte();
  const int a = src_.byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_num_ = 0;
}

void Decoder::get_dht() {
  long length = src_.u16() - 2;
  while (length > 16) {
    int index = src_.byte();
    uint8_t bits[17];
    bits[0] = 0;
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = static_cast<uint8_t>(src_.byte());
      count += bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length) fail(kMalformed);
    uint8_t vals[256] = {};
    for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(src_.byte());
    length -= count;
    HuffTable* t;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) fail(kMalformed);
      t = &ac_tables_[index];
    } else {
      if (index < 0 || index >= 4) fail(kMalformed);
      t = &dc_tables_[index];
    }
    t->defined = true;
    std::memcpy(t->bits, bits, sizeof(bits));
    std::memcpy(t->vals, vals, sizeof(vals));
  }
  if (length != 0) fail(kMalformed);
}

void Decoder::get_dqt() {
  long length = src_.u16() - 2;
  while (length > 0) {
    --length;
    int n = src_.byte();
    const int prec = n >> 4;
    n &= 0x0f;
    if (n >= 4) fail(kMalformed);
    quant_defined_[n] = true;
    for (int i = 0; i < 64; ++i) {
      const int tmp = prec ? src_.u16() : src_.byte();
      quant_[n][kNatural[i]] = static_cast<uint16_t>(tmp);
    }
    length -= 64;
    if (prec) length -= 64;
  }
  if (length != 0) fail(kMalformed);
}

void Decoder::get_dri() {
  if (src_.u16() != 4) fail(kMalformed);
  restart_interval_ = src_.u16();
}

void Decoder::get_dac() {
  long length = src_.u16() - 2;
  while (length > 0) {
    const int index = src_.byte();
    const int val = src_.byte();
    length -= 2;
    if (index < 0 || index >= 32) fail(kMalformed);
    if (index < 16 && (val & 0x0f) > (val >> 4)) fail(kMalformed);
  }
  if (length != 0) fail(kMalformed);
}

void Decoder::get_app() {
  long length = src_.u16() - 2;
  uint8_t b[14];
  const int numtoread = length >= 14 ? 14 : (length > 0 ? static_cast<int>(length) : 0);
  for (int i = 0; i < numtoread; ++i) b[i] = static_cast<uint8_t>(src_.byte());
  length -= numtoread;
  if (unread_marker_ == M_APP0) {
    if (numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
        b[3] == 'F' && b[4] == 0)
      saw_jfif_ = true;
  } else {
    if (numtoread >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' &&
        b[3] == 'b' && b[4] == 'e') {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
  }
  src_.skip(length);
}

void Decoder::skip_variable() {
  const long length = src_.u16() - 2;
  src_.skip(length);
}

// jdinput.c initial_setup, at the first SOS
void Decoder::initial_setup() {
  if (height_ > 65500 || width_ > 65500) fail(kMalformed);
  if (precision_ != 8) fail(kPrecision);
  const int n = static_cast<int>(comps_.size());
  if (n > 10) fail(kMalformed);
  for (auto& c : comps_) {
    if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail(kMalformed);
    if (c.h > max_h_) max_h_ = c.h;
    if (c.v > max_v_) max_v_ = c.v;
  }
  // the colour conversion libjpeg would set up for JCS_RGB output
  if (n == 4) fail(kCmyk);
  if (n != 1 && n != 3) fail(kComponents);
  // jdsample.c: each component's factors must divide the largest ones
  for (auto& c : comps_)
    if (max_h_ % c.h || max_v_ % c.v) fail(kMalformed);
  if (static_cast<uint64_t>(width_) * static_cast<uint64_t>(height_) > kMaxPixels)
    fail(kTooLarge);
  mcus_per_row_ = (width_ + max_h_ * 8 - 1) / (max_h_ * 8);
  mcu_rows_ = (height_ + max_v_ * 8 - 1) / (max_v_ * 8);
  for (auto& c : comps_) {
    c.dsw = static_cast<int>((static_cast<long>(width_) * c.h + max_h_ - 1) / max_h_);
    c.dsh = static_cast<int>((static_cast<long>(height_) * c.v + max_v_ - 1) / max_v_);
    c.wib = (c.dsw + 7) / 8;
    c.hib = (c.dsh + 7) / 8;
    c.bw = mcus_per_row_ * c.h;
    c.bh = mcu_rows_ * c.v;
    if (c.bw < c.wib) c.bw = c.wib;
    if (c.bh < c.hib) c.bh = c.hib;
    try {
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    } catch (const std::bad_alloc&) {
      fail(kNoMemory);
    }
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
  }
  multi_scan_ = comps_in_scan_ < n || progressive_;
}

// -- bit reader (jpeg_fill_bit_buffer) -------------------------------------

void Decoder::fill(int nbits) {
  if (unread_marker_ == 0) {
    while (bits_ < 57) {
      int c = src_.byte();
      if (c == 0xff) {
        do {
          c = src_.byte();
        } while (c == 0xff);
        if (c == 0) {
          c = 0xff;
        } else {
          unread_marker_ = c;
          goto no_more_bytes;
        }
      }
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
      bits_ += 8;
    }
    return;
  }
no_more_bytes:
  if (nbits > bits_) {
    // past the marker: zeros, and the rest of the segment is left as is
    insufficient_ = true;
    buf_ <<= 57 - bits_;
    bits_ = 57;
  }
}

int Decoder::decode(const Derived& d) {
  int l;
  if (bits_ < 8) {
    fill(0);
    if (bits_ < 8) {
      l = 1;
      goto slow;
    }
  }
  {
    const int look = static_cast<int>((buf_ >> (bits_ - 8)) & 0xff);
    const int e = d.lookup[look];
    l = e >> 8;
    if (l <= 8) {
      bits_ -= l;
      return e & 0xff;
    }
  }
slow:
  {
    int32_t code = get_bits(l);
    while (code > d.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      ++l;
    }
    if (l > 16) return 0;  // a damaged code decodes as symbol 0
    return d.vals[(code + d.valoffset[l]) & 0xff];
  }
}

// -- scans --------------------------------------------------------------

bool Decoder::read_restart_marker() {
  if (unread_marker_ == 0) next_marker();
  const int desired = next_restart_num_;
  if (unread_marker_ == M_RST0 + desired) {
    unread_marker_ = 0;
  } else {
    // jpeg_resync_to_restart
    int marker = unread_marker_;
    for (;;) {
      int action;
      if (marker < M_SOF0) {
        action = 2;
      } else if (marker < M_RST0 || marker > M_RST7) {
        action = 3;
      } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                 marker == M_RST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                 marker == M_RST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        break;
      }
      if (action == 3) break;
      next_marker();
      marker = unread_marker_;
    }
  }
  next_restart_num_ = (next_restart_num_ + 1) & 7;
  return true;
}

void Decoder::process_restart() {
  bits_ = 0;
  read_restart_marker();
  for (int i = 0; i < comps_in_scan_; ++i) last_dc_[i] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (unread_marker_ == 0) insufficient_ = false;
}

void Decoder::mcu_sequential(int16_t** blocks) {
  int blkn = 0;
  for (int ci = 0; ci < comps_in_scan_; ++ci) {
    Component* c = scan_comps_[ci];
    const Derived& dc = dc_derived_[c->dc_tbl];
    const Derived& ac = ac_derived_[c->ac_tbl];
    const int nb = comps_in_scan_ == 1 ? 1 : c->h * c->v;
    for (int b = 0; b < nb; ++b, ++blkn) {
      int16_t* block = blocks[blkn];
      int s = decode(dc);
      if (s) {
        const int r = get_bits(s);
        s = extend(r, s);
      }
      // int wraps as libjpeg's does; the block keeps the low 16 bits
      last_dc_[ci] = static_cast<int>(static_cast<unsigned>(s) +
                                      static_cast<unsigned>(last_dc_[ci]));
      block[0] = static_cast<int16_t>(last_dc_[ci]);
      for (int k = 1; k < 64; ++k) {
        s = decode(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          r = get_bits(s);
          s = extend(r, s);
          block[kNatural[k]] = static_cast<int16_t>(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }
}

void Decoder::mcu_dc_first(int16_t** blocks) {
  int blkn = 0;
  for (int ci = 0; ci < comps_in_scan_; ++ci) {
    Component* c = scan_comps_[ci];
    const Derived& dc = dc_derived_[c->dc_tbl];
    const int nb = comps_in_scan_ == 1 ? 1 : c->h * c->v;
    for (int b = 0; b < nb; ++b, ++blkn) {
      int s = decode(dc);
      if (s) {
        const int r = get_bits(s);
        s = extend(r, s);
      }
      const int64_t sum = static_cast<int64_t>(s) + last_dc_[ci];
      if (sum > INT32_MAX || sum < INT32_MIN) fail(kMalformed);
      last_dc_[ci] = static_cast<int>(sum);
      blocks[blkn][0] = static_cast<int16_t>(
          static_cast<unsigned>(last_dc_[ci]) << al_);
    }
  }
}

void Decoder::mcu_ac_first(int16_t* block) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Derived& ac = ac_derived_[scan_comps_[0]->ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    int s = decode(ac);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      r = get_bits(s);
      s = extend(r, s);
      block[kNatural[k]] =
          static_cast<int16_t>(static_cast<unsigned>(s) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1u << r;
      if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
      --eobrun_;
      break;
    }
  }
}

void Decoder::mcu_dc_refine(int16_t** blocks) {
  const int p1 = 1 << al_;
  int blkn = 0;
  for (int ci = 0; ci < comps_in_scan_; ++ci) {
    Component* c = scan_comps_[ci];
    const int nb = comps_in_scan_ == 1 ? 1 : c->h * c->v;
    for (int b = 0; b < nb; ++b, ++blkn)
      if (get_bits(1)) blocks[blkn][0] = static_cast<int16_t>(blocks[blkn][0] | p1);
  }
}

void Decoder::mcu_ac_refine(int16_t* block) {
  const int p1 = 1 << al_;
  const int m1 = static_cast<int>(~0u << al_);
  const Derived& ac = ac_derived_[scan_comps_[0]->ac_tbl];
  int k = ss_;
  auto correct = [&](int16_t* coef) {
    if (get_bits(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  };
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int s = decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        s = get_bits(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1u << r;
        if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
        break;
      }
      do {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = block + kNatural[k];
      if (*coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

void Decoder::decode_scan() {
  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables
  int blocks_in_mcu = 0;
  for (int i = 0; i < comps_in_scan_; ++i) {
    Component* c = scan_comps_[i];
    blocks_in_mcu += comps_in_scan_ == 1 ? 1 : c->h * c->v;
  }
  if (blocks_in_mcu > 10) fail(kMalformed);
  for (int i = 0; i < comps_in_scan_; ++i) {
    Component* c = scan_comps_[i];
    if (c->latched) continue;
    if (c->tq < 0 || c->tq >= 4 || !quant_defined_[c->tq]) fail(kMalformed);
    std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
    c->latched = true;
  }
  // entropy decoder start_pass
  auto need = [&](bool is_dc, int tbl) {
    if (tbl < 0 || tbl >= 4) fail(kMalformed);
    const HuffTable& t = is_dc ? dc_tables_[tbl] : ac_tables_[tbl];
    if (!t.defined) fail(kMalformed);
    derive(t, is_dc, is_dc ? &dc_derived_[tbl] : &ac_derived_[tbl]);
  };
  const bool dc_band = ss_ == 0;
  if (progressive_) {
    bool bad = false;
    if (dc_band) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ >= 64) bad = true;
      if (comps_in_scan_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) fail(kMalformed);
    for (int i = 0; i < comps_in_scan_; ++i) {
      Component* c = scan_comps_[i];
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
    }
    for (int i = 0; i < comps_in_scan_; ++i) {
      Component* c = scan_comps_[i];
      if (dc_band) {
        if (ah_ == 0) need(true, c->dc_tbl);
      } else {
        need(false, c->ac_tbl);
      }
    }
  } else {
    for (int i = 0; i < comps_in_scan_; ++i) {
      need(true, scan_comps_[i]->dc_tbl);
      need(false, scan_comps_[i]->ac_tbl);
    }
  }
  for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
  bits_ = 0;
  buf_ = 0;
  insufficient_ = false;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;

  int rows, cols;
  if (comps_in_scan_ == 1) {
    cols = scan_comps_[0]->wib;
    rows = scan_comps_[0]->hib;
  } else {
    cols = mcus_per_row_;
    rows = mcu_rows_;
  }
  int16_t* blocks[10];
  for (int my = 0; my < rows; ++my) {
    for (int mx = 0; mx < cols; ++mx) {
      int blkn = 0;
      for (int i = 0; i < comps_in_scan_; ++i) {
        Component* c = scan_comps_[i];
        if (comps_in_scan_ == 1) {
          blocks[blkn++] = &c->coef[(static_cast<size_t>(my) * c->bw + mx) * 64];
        } else {
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x)
              blocks[blkn++] = &c->coef[(static_cast<size_t>(my * c->v + y) * c->bw +
                                         mx * c->h + x) * 64];
        }
      }
      if (restart_interval_) {
        if (restarts_to_go_ == 0) process_restart();
      }
      if (progressive_ && dc_band && ah_ != 0) {
        // a DC refinement reads on past the data: zeros change nothing
        mcu_dc_refine(blocks);
      } else if (!insufficient_) {
        if (!progressive_)
          mcu_sequential(blocks);
        else if (dc_band)
          mcu_dc_first(blocks);
        else if (ah_ == 0)
          mcu_ac_first(blocks[0]);
        else
          mcu_ac_refine(blocks[0]);
      }
      if (restart_interval_) --restarts_to_go_;
    }
  }
  bits_ = 0;
}

// -- inverse DCT ---------------------------------------------------------
//
// libjpeg-turbo's jsimd_idct_islow (SSE2/AVX2) computes jidctint.c's
// islow IDCT in 16-bit lanes: the dequantised coefficients, in0 +/- in4
// and the odd-part sums z3 = in7 + in3, z4 = in5 + in1 wrap at 16 bits,
// products and the rest are 32-bit, each pass packs with signed
// saturation, and the last pack saturates to int8 before +128.  A block
// whose rows 1-7 are all zero takes its first pass as (dc * q) << 2 in
// 16 bits.  For coefficients a valid stream produces this is the C
// version's result exactly.

inline int16_t wrap16(uint32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t sat16(int32_t x) { return x > 32767 ? 32767 : (x < -32768 ? -32768 : x); }

constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

// one 8-point pass on int16 inputs; returns the 32-bit pre-descale sums
inline void idct_1d(const int32_t* in, uint32_t* out) {
  const uint32_t i0 = static_cast<uint32_t>(in[0]), i1 = static_cast<uint32_t>(in[1]),
                 i2 = static_cast<uint32_t>(in[2]), i3 = static_cast<uint32_t>(in[3]),
                 i4 = static_cast<uint32_t>(in[4]), i5 = static_cast<uint32_t>(in[5]),
                 i6 = static_cast<uint32_t>(in[6]), i7 = static_cast<uint32_t>(in[7]);
  const uint32_t tmp3 = i2 * uint32_t(F_0_541 + F_0_765) + i6 * uint32_t(F_0_541);
  const uint32_t tmp2 = i2 * uint32_t(F_0_541) + i6 * uint32_t(F_0_541 - F_1_847);
  const uint32_t tmp0 = static_cast<uint32_t>(static_cast<int32_t>(wrap16(i0 + i4)) * 8192);
  const uint32_t tmp1 = static_cast<uint32_t>(static_cast<int32_t>(wrap16(i0 - i4)) * 8192);
  const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const uint32_t z3 = static_cast<uint32_t>(static_cast<int32_t>(wrap16(i7 + i3)));
  const uint32_t z4 = static_cast<uint32_t>(static_cast<int32_t>(wrap16(i5 + i1)));
  const uint32_t z3p = z3 * uint32_t(F_1_175 - F_1_961) + z4 * uint32_t(F_1_175);
  const uint32_t z4p = z3 * uint32_t(F_1_175) + z4 * uint32_t(F_1_175 - F_0_390);
  const uint32_t o0 = i7 * uint32_t(F_0_298 - F_0_899) + i1 * uint32_t(-F_0_899) + z3p;
  const uint32_t o1 = i5 * uint32_t(F_2_053 - F_2_562) + i3 * uint32_t(-F_2_562) + z4p;
  const uint32_t o3 = i7 * uint32_t(-F_0_899) + i1 * uint32_t(F_1_501 - F_0_899) + z4p;
  const uint32_t o2 = i5 * uint32_t(-F_2_562) + i3 * uint32_t(F_3_072 - F_2_562) + z3p;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

inline int32_t descale(uint32_t x, int n) {
  return static_cast<int32_t>(x + (uint32_t(1) << (n - 1))) >> n;
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                size_t stride) {
  int32_t ws[64];
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = coef[k] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t d = wrap16(static_cast<uint32_t>(coef[c]) * static_cast<uint32_t>(q[c]));
      const int32_t v = wrap16(static_cast<uint32_t>(d) << 2);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    int32_t in[8];
    uint32_t o[8];
    for (int c = 0; c < 8; ++c) {
      for (int r = 0; r < 8; ++r)
        in[r] = wrap16(static_cast<uint32_t>(coef[r * 8 + c]) *
                       static_cast<uint32_t>(q[r * 8 + c]));
      idct_1d(in, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(descale(o[r], 11));
    }
  }
  uint32_t o[8];
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + r * 8, o);
    uint8_t* row = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t v = sat16(descale(o[c], 18));
      v = v > 127 ? 127 : (v < -128 ? -128 : v);
      row[c] = static_cast<uint8_t>(v + 128);
    }
  }
}

void Decoder::inverse_dct() {
  for (auto& c : comps_) {
    const size_t stride = static_cast<size_t>(c.wib) * 8;
    try {
      c.plane.assign(stride * c.hib * 8, 0);
    } catch (const std::bad_alloc&) {
      fail(kNoMemory);
    }
    int16_t q[64];
    for (int k = 0; k < 64; ++k) q[k] = static_cast<int16_t>(c.quant[k]);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], q,
                   &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  }
}

// -- upsampling and colour conversion -------------------------------------

// One output row of component c (jdsample.c, fancy upsampling): a pointer
// to the row in the plane (full size) or to `out`, which holds at least
// 2 * dsw samples.
const uint8_t* upsample_row(const Component& c, int max_h, int max_v, int y,
                            uint8_t* out) {
  const size_t stride = static_cast<size_t>(c.wib) * 8;
  const int hx = max_h / c.h, vx = max_v / c.v;
  const int dsw = c.dsw;
  const int r = y / vx;
  const uint8_t* in0 = &c.plane[static_cast<size_t>(r) * stride];
  if (hx == 1 && vx == 1) return in0;
  uint8_t* o = out;
  if (hx == 2 && vx == 1) {
    if (dsw > 2) {
      const uint8_t* in = in0;
      int inv = *in++;
      *o++ = static_cast<uint8_t>(inv);
      *o++ = static_cast<uint8_t>((inv * 3 + in[0] + 2) >> 2);
      for (int col = dsw - 2; col > 0; --col) {
        inv = (*in++) * 3;
        *o++ = static_cast<uint8_t>((inv + in[-2] + 1) >> 2);
        *o++ = static_cast<uint8_t>((inv + in[0] + 2) >> 2);
      }
      inv = *in;
      *o++ = static_cast<uint8_t>((inv * 3 + in[-1] + 1) >> 2);
      *o++ = static_cast<uint8_t>(inv);
    } else {  // too narrow for fancy: plain replication
      for (int i = 0; i < dsw; ++i) o[2 * i] = o[2 * i + 1] = in0[i];
    }
    return out;
  }
  if (vx != 2 || hx > 2 || (hx == 2 && dsw <= 2)) {
    // int_upsample (and h2v2 too narrow for fancy): plain replication
    for (int i = 0; i < dsw; ++i)
      for (int j = 0; j < hx; ++j) o[i * hx + j] = in0[i];
    return out;
  }
  // vertical context: the row above (even output rows) or below (odd),
  // the first and last rows replicated at the image's edges
  const int v = y % 2;
  int rn = v == 0 ? r - 1 : r + 1;
  if (rn < 0) rn = 0;
  if (rn > c.dsh - 1) rn = c.dsh - 1;
  const uint8_t* in1 = &c.plane[static_cast<size_t>(rn) * stride];
  if (hx == 1) {  // h1v2
    const int bias = v == 0 ? 1 : 2;
    for (int i = 0; i < dsw; ++i)
      o[i] = static_cast<uint8_t>((in0[i] * 3 + in1[i] + bias) >> 2);
    return out;
  }
  // h2v2
  const uint8_t* a = in0;
  const uint8_t* b = in1;
  int thiscol = (*a++) * 3 + (*b++);
  int nextcol = (*a++) * 3 + (*b++);
  *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
  int lastcol = thiscol;
  thiscol = nextcol;
  for (int col = dsw - 2; col > 0; --col) {
    nextcol = (*a++) * 3 + (*b++);
    *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    lastcol = thiscol;
    thiscol = nextcol;
  }
  *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
  *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

const YccTables& ycc() {
  static const YccTables t;
  return t;
}

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x)); }

uint8_t* Decoder::color_convert(int* out_w, int* out_h) {
  const int w = width_, h = height_;
  const size_t stride = static_cast<size_t>(w) * 3;
  const int n = static_cast<int>(comps_.size());
  // jdapimin.c default_decompress_parms: the stream's colour space
  bool ycbcr = true;
  if (n == 3 && !saw_jfif_) {
    if (saw_adobe_)
      ycbcr = adobe_transform_ != 0;
    else
      ycbcr = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
  }
  uint8_t* out = static_cast<uint8_t*>(std::malloc(stride * h));
  if (!out) fail(kNoMemory);
  const size_t row = 2 * static_cast<size_t>(w) + 16;
  std::vector<uint8_t> scratch(3 * row);
  const YccTables& t = ycc();
  for (int y = 0; y < h; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * stride;
    if (n == 1) {
      const uint8_t* g = upsample_row(comps_[0], max_h_, max_v_, y, scratch.data());
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    const uint8_t* p0 = upsample_row(comps_[0], max_h_, max_v_, y, scratch.data());
    const uint8_t* p1 = upsample_row(comps_[1], max_h_, max_v_, y, scratch.data() + row);
    const uint8_t* p2 = upsample_row(comps_[2], max_h_, max_v_, y, scratch.data() + 2 * row);
    if (ycbcr) {
      for (int x = 0; x < w; ++x) {
        const int yy = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x] = clamp255(yy + t.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
      }
    } else {
      for (int x = 0; x < w; ++x) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
      }
    }
  }
  *out_w = w;
  *out_h = h;
  return out;
}

// -- decode ---------------------------------------------------------------

void Decoder::fill_std_tables() {
  struct Std {
    HuffTable* t;
    const uint8_t* bits;
    const uint8_t* vals;
    size_t n;
  } const std_tables[] = {
      {&dc_tables_[0], kStdDcLumBits, kStdDcLumVals, sizeof(kStdDcLumVals)},
      {&dc_tables_[1], kStdDcChrBits, kStdDcChrVals, sizeof(kStdDcChrVals)},
      {&ac_tables_[0], kStdAcLumBits, kStdAcLumVals, sizeof(kStdAcLumVals)},
      {&ac_tables_[1], kStdAcChrBits, kStdAcChrVals, sizeof(kStdAcChrVals)},
  };
  for (const Std& s : std_tables) {
    if (s.t->defined) continue;
    s.t->defined = true;
    std::memcpy(s.t->bits, s.bits, 17);
    std::memcpy(s.t->vals, s.vals, s.n);
  }
}

uint8_t* Decoder::run(int* out_w, int* out_h) {
  // jpeg_read_header: markers up to the first SOS
  if (read_markers() != M_SOS) fail(kMalformed);  // tables-only stream
  initial_setup();
  // jinit_huff_decoder: a sequential stream's missing tables 0 and 1 are
  // the standard ones (a progressive stream gets none)
  if (!progressive_) fill_std_tables();
  for (;;) {
    decode_scan();
    const int m = read_markers();
    if (m == M_EOI) break;
    if (!multi_scan_) fail(kMalformed);
  }
  if (progressive_) {
    // decompress_smooth_data would run (jdcoefct.c smoothing_ok)
    bool useful = false, ok = true;
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (auto& c : comps_) {
      if (!c.latched) {
        ok = false;
        break;
      }
      for (int k : kQ)
        if (c.quant[k] == 0) ok = false;
      if (c.coef_bits[0] < 0) ok = false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (ok && useful) fail(kSmoothing);
  }
  inverse_dct();
  return color_convert(out_w, out_h);
}

uint8_t* decode_buffer(const uint8_t* data, size_t size, int* w, int* h,
                       int* why) {
  *w = *h = 0;
  int code = kOk;
  uint8_t* out = nullptr;
  try {
    Decoder d(data, size);
    out = d.run(w, h);
  } catch (const Fail& f) {
    code = f.why;
  } catch (const std::bad_alloc&) {
    code = kNoMemory;
  }
  if (why) *why = code;
  if (!out) *w = *h = 0;
  return out;
}

uint8_t* decode_file(const char* path, int* w, int* h, int* why) {
  *w = *h = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    if (why) *why = kIo;
    return nullptr;
  }
  // a directory opens for reading, and its size says nothing of a file's
  struct stat st;
  if (fstat(fileno(f), &st) != 0 || !S_ISREG(st.st_mode) || st.st_size <= 0) {
    std::fclose(f);
    if (why) *why = kIo;
    return nullptr;
  }
  std::vector<uint8_t> buf;
  try {
    buf.resize(static_cast<size_t>(st.st_size));
  } catch (const std::exception&) {  // bad_alloc, or length_error
    std::fclose(f);
    if (why) *why = kNoMemory;
    return nullptr;
  }
  const size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) {
    if (why) *why = kIo;
    return nullptr;
  }
  return decode_buffer(buf.data(), buf.size(), w, h, why);
}

}  // namespace

extern "C" {

// Bumped on any signature change: the bridge refuses a library whose
// symbols resolve but whose argument layout moved.
int dfd_jpeg_abi_version(void) { return 1; }

const char* dfd_jpeg_reason(int why) {
  if (why < 0 || why >= static_cast<int>(sizeof(kReasons) / sizeof(kReasons[0])))
    return "unknown";
  return kReasons[why];
}

void dfd_jpeg_free(uint8_t* p) { std::free(p); }

// Decode a JPEG byte buffer to tightly packed RGB8 (malloc'd, freed with
// dfd_jpeg_free), or null with *why set.
uint8_t* dfd_jpeg_decode(const uint8_t* data, size_t size, int* w, int* h,
                         int* why) {
  return decode_buffer(data, size, w, h, why);
}

uint8_t* dfd_jpeg_decode_file(const char* path, int* w, int* h, int* why) {
  return decode_file(path, w, h, why);
}

void* dfd_jpeg_pool_new(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new dfd_native::Pool(n_threads);
}

void dfd_jpeg_pool_free(void* pool) {
  delete static_cast<dfd_native::Pool*>(pool);
}

// Decode n files (or buffers) on the pool; blocks until all are done.
void dfd_jpeg_pool_decode_files(void* pool, int n, const char** paths,
                                uint8_t** outs, int* ws, int* hs,
                                int* whys) {
  dfd_native::Pool* p = static_cast<dfd_native::Pool*>(pool);
  dfd_native::Latch latch(n);
  for (int i = 0; i < n; ++i) {
    p->Submit([&, i] {
      outs[i] = decode_file(paths[i], &ws[i], &hs[i], &whys[i]);
      latch.Done();
    });
  }
  latch.Wait();
}

void dfd_jpeg_pool_decode_buffers(void* pool, int n, const uint8_t** datas,
                                  const size_t* sizes, uint8_t** outs,
                                  int* ws, int* hs, int* whys) {
  dfd_native::Pool* p = static_cast<dfd_native::Pool*>(pool);
  dfd_native::Latch latch(n);
  for (int i = 0; i < n; ++i) {
    p->Submit([&, i] {
      outs[i] = decode_buffer(datas[i], sizes[i], &ws[i], &hs[i], &whys[i]);
      latch.Done();
    });
  }
  latch.Wait();
}

}  // extern "C"
