// The port's JPEG decode pool: a baseline JPEG decoder written for the port
// and a thread pool that decodes whole batches straight into the canvas.
//
// Counterpart of the reference package's C++ pool (loader.cc), which runs
// the same pool over libjpeg.  The card's host has no libjpeg, so this file
// decodes by itself and links no JPEG library.  Its output is byte-equal to
// libjpeg-turbo's default decode to RGB (JDCT_ISLOW, fancy upsampling), the
// decoder that cv2 and PIL wrap; the names of libjpeg's source files below
// only say which semantics each part matches.
//
// Accepted: SOF0/SOF1 at 8 bits, 1 component (grey, any sampling) or 3
// (YCbCr) with luma 1x1, 2x1 or 2x2 over chroma 1x1; one interleaved
// Huffman scan (the standard's tables for a slot 0 or 1 that no DHT
// defines); DQT 8- and 16-bit; DRI and RST0-7; APPn, COM and DNL skipped.
// Refused (nonzero return, nothing written): progressive, arithmetic,
// lossless and 12-bit files, 2 or 4 components, other samplings (4:1:1,
// 4:4:0, ...), RGB files (Adobe transform 0, or component ids 'R','G','B'
// with no JFIF marker), scans that do not hold every component, missing
// tables, and every header libjpeg itself rejects.
//
// Data that ends early decodes as libjpeg decodes it: past the end of the
// file the source yields a fake EOI (jdatasrc.c); the bit reader then feeds
// zero bits and marks the data insufficient (jdhuff.c); the MCU it ran out
// in is decoded to its end on those bits, and every later MCU keeps
// all-zero coefficients (mid grey), also across restart markers.  The
// inverse DCT keeps the integer widths of libjpeg-turbo's x86 SIMD version
// (the one cv2, PIL and the system libjpeg run), which saturates where the
// C version's range-limit table wraps: the two differ only on such data.
//
// Exposed C ABI (ctypes-bound in peclr_tpu_torch/data/native_loader.py):
//   peclr_decode_jpeg  - one file -> RGB8 buffer
//   peclr_decode_batch - N files -> (N, canvas, canvas, 3) canvas batch,
//                        decoded by up to `threads` workers pulling from one
//                        atomic index; a frame of another size is resized
//                        to the canvas by nearest neighbour; a failed
//                        frame is zeroed.
//
// All decoder state lives in one Decoder object per call, so workers share
// nothing but the read-only inputs.  Plain scalar C++17: SIMD and decode on
// the card are later work.

#include <array>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kEOI = 0xD9;
constexpr int kMaxDimension = 65500;  // JPEG_MAX_DIMENSION

// Zigzag position -> natural (row-major) position, with 16 extra entries
// of 63 so that a run past the end of a block lands on its last
// coefficient, as libjpeg's jpeg_natural_order does.
constexpr int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The typical Huffman tables of the JPEG standard (ITU-T T.81, Annex K.3):
// a table a scan uses in slot 0 or 1 that no DHT defined takes these, as in
// libjpeg-turbo (jstdhuff.c, for Motion-JPEG frames).  Counts of codes of
// each length 1..16, then the symbols.
constexpr uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct Image {
  std::vector<unsigned char> data;  // RGB8, h rows of w pixels
  int h = 0;
  int w = 0;
};

// The file's bytes, then FF D9 repeated: libjpeg's data sources insert a
// fake EOI each time they are asked for bytes past the end of the file.
struct Source {
  std::vector<uint8_t> bytes;
  size_t pos = 0;

  int byte() {
    const size_t i = pos++;
    if (i < bytes.size()) return bytes[i];
    return ((i - bytes.size()) & 1) ? kEOI : 0xFF;
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    if (n > 0) pos += static_cast<size_t>(n);
  }
};

// Bits peeked at once to decode a Huffman code.  Any width decodes the
// same; libjpeg peeks 8, and 11 takes most of the codes of noisy,
// high-quality frames in one look.
constexpr int kLookBits = 11;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};   // number of codes of each length 1..16
  uint8_t vals[256] = {};  // symbols in code order
  // derived (jpeg_make_d_derived_tbl)
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // the codes of at most kLookBits bits, by the next kLookBits bits:
  // (length << 8) | symbol; for the first kLookBits bits of longer codes
  // kSubTable | the index in `sub` of a table of those codes by their
  // next 16 - kLookBits bits; kBadCode where no code starts so
  uint16_t lookup[1 << kLookBits] = {};
  std::vector<std::array<uint16_t, 1 << (16 - kLookBits)>> sub;
};

constexpr uint16_t kSubTable = 0x8000;
// a bad code: libjpeg reads 17 bits looking for it and decodes 0
constexpr uint16_t kBadCode = 17 << 8;

struct Component {
  int id = 0;
  int h = 1, v = 1;  // sampling factors
  int tq = 0;        // quantization table
  int td = 0, ta = 0;  // DC and AC Huffman tables of the scan
  int dw = 0, dh = 0;  // downsampled width and height (ceil)
  int stride = 0;      // plane width, whole blocks
  std::vector<uint8_t> plane;
  int16_t quant[64] = {};  // natural order, latched at the scan
  int dc_pred = 0;
};

class Decoder {
 public:
  // Decodes `src`; false on any error.  With a `capacity` >= 0, returns
  // false with *too_large set when the RGB image would not fit in that
  // many bytes, before decoding its scan.
  bool run(Source* src, long long capacity, bool* too_large);
  int width() const { return width_; }
  int height() const { return height_; }
  // The decoded image as RGB8, height() rows of width() pixels.
  void to_rgb(uint8_t* out) const;

 private:
  bool read_headers();
  bool read_sof(int marker);
  bool read_dht();
  bool read_dqt();
  bool read_dri();
  bool read_dac();
  bool read_app(int marker);
  bool read_sos();
  bool skip_segment();
  bool read_misc_marker(int m, bool* other);
  bool finish_markers();
  void next_marker();
  bool decode_scan();
  bool build_table(HuffTable* t, bool dc);
  void process_restart();
  void resync_to_restart(int desired);

  // bit reader (jdhuff.c's jpeg_fill_bit_buffer, HUFF_DECODE, GET_BITS)
  void fill(int nbits);
  int get_bits(int n) {
    if (bits_left_ < n) fill(n);
    bits_left_ -= n;
    return static_cast<int>((bit_buf_ >> bits_left_) & ((1u << n) - 1));
  }
  int decode_symbol(const HuffTable& t);
  int decode_long(const HuffTable& t, int length);
  void decode_block(Component* c, int16_t* block);
  bool decode_block_fast(Component* c, int16_t* block);

  void idct_block(const int16_t* coef, const int16_t* quant, uint8_t* out,
                  int stride) const;
  const uint8_t* upsample_row(const Component& c, int y, uint8_t* row) const;

  Source* src_ = nullptr;
  int unread_marker_ = 0;
  bool saw_sof_ = false;
  bool saw_jfif_ = false;
  bool saw_adobe_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0;
  int ncomp_ = 0;
  Component comp_[3];
  int max_h_ = 1, max_v_ = 1;
  int scan_order_[3] = {0, 1, 2};  // components in the scan's order
  uint16_t qtab_[4][64] = {};
  bool qdefined_[4] = {};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  int next_restart_num_ = 0;
  int restarts_to_go_ = 0;
  bool insufficient_ = false;
  uint64_t bit_buf_ = 0;
  int bits_left_ = 0;
};

// ---------------------------------------------------------------------------
// markers (jdmarker.c)

// Skip to the next marker (any bytes, and FF 00 pairs, before it) and
// make it the unread marker.
void Decoder::next_marker() {
  int c;
  for (;;) {
    c = src_->byte();
    while (c != 0xFF) c = src_->byte();
    do {
      c = src_->byte();
    } while (c == 0xFF);
    if (c != 0) break;
  }
  unread_marker_ = c;
}

bool Decoder::skip_segment() {
  const int length = src_->word();
  src_->skip(length - 2);
  return true;
}

bool Decoder::read_app(int marker) {
  // the first 14 bytes are examined for JFIF (APP0) and Adobe (APP14)
  long length = src_->word() - 2;
  const int numtoread = length >= 14 ? 14 : (length > 0 ? int(length) : 0);
  uint8_t b[14];
  for (int i = 0; i < numtoread; ++i) b[i] = static_cast<uint8_t>(src_->byte());
  length -= numtoread;
  if (marker == 0xE0 && numtoread >= 14 && b[0] == 'J' && b[1] == 'F' &&
      b[2] == 'I' && b[3] == 'F' && b[4] == 0) {
    saw_jfif_ = true;
  } else if (marker == 0xEE && numtoread >= 12 && b[0] == 'A' &&
             b[1] == 'd' && b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
    saw_adobe_ = true;
    adobe_transform_ = b[11];
  }
  src_->skip(length);
  return true;
}

bool Decoder::read_sof(int marker) {
  if (marker != 0xC0 && marker != 0xC1) return false;  // not Huffman sequential
  if (saw_sof_) return false;
  saw_sof_ = true;
  const int length = src_->word();
  const int precision = src_->byte();
  height_ = src_->word();
  width_ = src_->word();
  ncomp_ = src_->byte();
  if (precision != 8 || height_ <= 0 || width_ <= 0 ||
      height_ > kMaxDimension || width_ > kMaxDimension)
    return false;
  if (ncomp_ != 1 && ncomp_ != 3) return false;
  if (length - 8 != ncomp_ * 3) return false;
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.id = src_->byte();
    const int hv = src_->byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = src_->byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return false;
  }
  if (ncomp_ == 1) {
    // a single-component scan is one block an MCU, whatever its factors
    comp_[0].h = comp_[0].v = 1;
  } else {
    const Component& y = comp_[0];
    const bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) ||
                         (y.h == 2 && y.v == 2);
    if (!luma_ok) return false;
    for (int i = 1; i < 3; ++i)
      if (comp_[i].h != 1 || comp_[i].v != 1) return false;
  }
  max_h_ = comp_[0].h;
  max_v_ = comp_[0].v;
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.dw = (width_ * c.h + max_h_ - 1) / max_h_;
    c.dh = (height_ * c.v + max_v_ - 1) / max_v_;
  }
  return true;
}

bool Decoder::read_dht() {
  long length = src_->word() - 2;
  while (length > 16) {
    const int index = src_->byte();
    uint8_t bits[17] = {};
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = static_cast<uint8_t>(src_->byte());
      count += bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) return false;
    HuffTable* t;
    if (index & 0x10) {
      if (index - 0x10 > 3) return false;
      t = &ac_[index - 0x10];
    } else {
      if (index > 3) return false;
      t = &dc_[index];
    }
    std::memcpy(t->bits, bits, sizeof(bits));
    std::memset(t->vals, 0, sizeof(t->vals));
    for (int i = 0; i < count; ++i) t->vals[i] = static_cast<uint8_t>(src_->byte());
    t->defined = true;
    length -= count;
  }
  return length == 0;
}

bool Decoder::read_dqt() {
  long length = src_->word() - 2;
  while (length > 0) {
    const int pq = src_->byte();
    const int prec = pq >> 4;
    const int n = pq & 15;
    if (n > 3) return false;
    for (int i = 0; i < 64; ++i) {
      const int value = prec ? src_->word() : src_->byte();
      qtab_[n][kNaturalOrder[i]] = static_cast<uint16_t>(value);
    }
    qdefined_[n] = true;
    length -= 65;
    if (prec) length -= 64;
  }
  return length == 0;
}

// DAC (arithmetic conditioning): only checked, as libjpeg checks it
bool Decoder::read_dac() {
  long length = src_->word() - 2;
  while (length > 0) {
    const int index = src_->byte();
    const int value = src_->byte();
    length -= 2;
    if (index >= 32) return false;
    if (index < 16 && (value & 15) > (value >> 4)) return false;
  }
  return length == 0;
}

bool Decoder::read_dri() {
  if (src_->word() != 4) return false;
  restart_interval_ = src_->word();
  return true;
}

bool Decoder::read_sos() {
  if (!saw_sof_) return false;
  const int length = src_->word();
  const int n = src_->byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) return false;
  // every component in one scan: progressive-like multi-scan files are
  // refused
  if (n != ncomp_) return false;
  bool seen[3] = {};
  for (int i = 0; i < n; ++i) {
    const int id = src_->byte();
    const int t = src_->byte();
    int ci = 0;
    while (ci < ncomp_ && (comp_[ci].id != id || seen[ci])) ++ci;
    if (ci == ncomp_) return false;
    seen[ci] = true;
    scan_order_[i] = ci;
    comp_[ci].td = t >> 4;
    comp_[ci].ta = t & 15;
    if (comp_[ci].td > 3 || comp_[ci].ta > 3) return false;
  }
  // Ss, Se, Ah/Al: libjpeg only warns when a sequential scan has others
  src_->byte();
  src_->byte();
  src_->byte();
  next_restart_num_ = 0;
  return true;
}

// A marker that may stand before or after the scan (tables, APPn, COM,
// DNL, DAC, RSTn, TEM), read as jdmarker.c's read_markers reads it.
// Returns false on a bad segment, and sets *other for any other marker.
bool Decoder::read_misc_marker(int m, bool* other) {
  *other = false;
  if (m == 0xC4) return read_dht();
  if (m == 0xDB) return read_dqt();
  if (m == 0xDD) return read_dri();
  if (m >= 0xE0 && m <= 0xEF) return read_app(m);
  if (m == 0xCC) return read_dac();
  if (m == 0xFE || m == 0xDC) return skip_segment();  // COM, DNL
  if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return true;  // RSTn, TEM
  *other = true;
  return true;
}

// jdmarker.c's read_markers up to the first SOS, and the colour space as
// jdapimin.c's default_decompress_parms picks it.
bool Decoder::read_headers() {
  if (src_->bytes.empty()) return false;
  if (src_->byte() != 0xFF || src_->byte() != 0xD8) return false;
  for (;;) {
    next_marker();
    const int m = unread_marker_;
    unread_marker_ = 0;
    bool other;
    if (!read_misc_marker(m, &other)) return false;
    if (!other) continue;
    if (m == 0xDA) {
      if (!read_sos()) return false;
      break;
    }
    // SOF0/SOF1 (others refused); EOI before any scan, a second SOI or an
    // unknown marker fail
    if (m < 0xC0 || m > 0xCF || m == 0xC8 || !read_sof(m)) return false;
  }
  if (ncomp_ == 3) {
    bool rgb;
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
    }
    if (rgb) return false;
  }
  return true;
}

// After the scan: jpeg_finish_decompress reads on to EOI, and fails on a
// second frame or scan.
bool Decoder::finish_markers() {
  for (;;) {
    if (unread_marker_ == 0) next_marker();
    const int m = unread_marker_;
    unread_marker_ = 0;
    if (m == kEOI) return true;
    bool other;
    if (!read_misc_marker(m, &other) || other) return false;
  }
}

// ---------------------------------------------------------------------------
// Huffman decoding (jdhuff.c)

bool Decoder::build_table(HuffTable* t, bool dc) {
  if (!t->defined) return false;
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = t->bits[l];
    if (p + n > 256) return false;
    for (int i = 0; i < n; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1u << si)) return false;  // overfull code
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t->bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t->bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // sentinel: ends every search
  for (int i = 0; i < (1 << kLookBits); ++i) t->lookup[i] = kBadCode;
  t->sub.clear();
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < t->bits[l]; ++i, ++p) {
      const uint16_t entry = static_cast<uint16_t>((l << 8) | t->vals[p]);
      if (l <= kLookBits) {
        int look = static_cast<int>(huffcode[p] << (kLookBits - l));
        for (int c = 1 << (kLookBits - l); c > 0; --c, ++look)
          t->lookup[look] = entry;
        continue;
      }
      const int head = static_cast<int>(huffcode[p] >> (l - kLookBits));
      if (!(t->lookup[head] & kSubTable)) {
        t->lookup[head] = static_cast<uint16_t>(kSubTable | t->sub.size());
        t->sub.emplace_back();
        t->sub.back().fill(kBadCode);
      }
      auto& table = t->sub[t->lookup[head] & ~kSubTable];
      const int rest = static_cast<int>(huffcode[p] & ((1u << (l - kLookBits)) - 1));
      for (int c = 0; c < 1 << (16 - l); ++c) table[(rest << (16 - l)) + c] = entry;
    }
  }
  if (dc) {
    for (int i = 0; i < numsymbols; ++i)
      if (t->vals[i] > 15) return false;
  }
  return true;
}

// Load the bit buffer to at least 57 bits, stopping at a marker.  Past
// the marker, a request for more bits than are left gets zero bits and
// marks the data insufficient.
void Decoder::fill(int nbits) {
  if (unread_marker_ == 0) {
    const uint8_t* data = src_->bytes.data();
    const size_t size = src_->bytes.size();
    while (bits_left_ < 57) {
      int c;
      if (src_->pos < size && data[src_->pos] != 0xFF) {
        c = data[src_->pos++];  // the common case: a plain data byte
      } else if ((c = src_->byte()) == 0xFF) {
        do {
          c = src_->byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;  // FF 00 is a data byte FF
        } else {
          unread_marker_ = c;
          break;
        }
      }
      bit_buf_ = (bit_buf_ << 8) | static_cast<uint64_t>(c);
      bits_left_ += 8;
    }
    if (unread_marker_ == 0) return;
  }
  if (nbits > bits_left_) {
    insufficient_ = true;
    bit_buf_ <<= 57 - bits_left_;
    bits_left_ = 57;
  }
}

int Decoder::decode_long(const HuffTable& t, int length) {
  int l = length;
  int32_t code = get_bits(l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | get_bits(1);
    ++l;
  }
  if (l > 16) return 0;  // a bad code decodes as 0, as libjpeg's does
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

int Decoder::decode_symbol(const HuffTable& t) {
  if (bits_left_ < kLookBits) {
    fill(0);
    if (bits_left_ < kLookBits) return decode_long(t, 1);
  }
  const int look = static_cast<int>((bit_buf_ >> (bits_left_ - kLookBits)) &
                                    ((1 << kLookBits) - 1));
  const uint16_t entry = t.lookup[look];
  if ((entry >> 8) <= kLookBits) {
    bits_left_ -= entry >> 8;
    return entry & 0xFF;
  }
  return decode_long(t, kLookBits + 1);
}

// HUFF_EXTEND: the s-bit value r as a signed coefficient (a leading 0
// bit makes it negative)
inline int extend(int r, int s) {
  return r + (((r - (1 << (s - 1))) >> 31) & (1 - (1 << s)));
}

void Decoder::decode_block(Component* c, int16_t* block) {
  int s = decode_symbol(dc_[c->td]);
  if (s) {
    const int r = get_bits(s);
    s = extend(r, s);
  }
  c->dc_pred = static_cast<int>(static_cast<unsigned>(c->dc_pred) +
                                 static_cast<unsigned>(s));
  block[0] = static_cast<int16_t>(c->dc_pred);
  const HuffTable& ac = ac_[c->ta];
  for (int k = 1; k < 64; ++k) {
    int rs = decode_symbol(ac);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      const int bits = get_bits(s);
      block[kNaturalOrder[k]] = static_cast<int16_t>(extend(bits, s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// decode_block on a block that lies wholly inside the file (at least
// kFastMargin bytes on): the same bits and coefficients, read with no end
// checks.  Returns false, with nothing of the decoder's state changed, at
// a marker; the caller then decodes the block with decode_block.  A block
// takes at most 64 codes of 16 bits and values of 15, 248 bytes, twice
// that with every byte stuffed, so the margin covers it and the look-ahead.
constexpr size_t kFastMargin = 512;

bool Decoder::decode_block_fast(Component* c, int16_t* block) {
  const uint8_t* data = src_->bytes.data();
  size_t pos = src_->pos;
  uint64_t buf = bit_buf_;
  int left = bits_left_;
  // top up to at least 57 bits; false at a marker
  auto refill = [&]() {
    while (left < 57) {
      // eight bytes at once where none of them is FF
      uint64_t w = 0;
      for (int i = 0; i < 8; ++i) w = (w << 8) | data[pos + i];
      constexpr uint64_t kOnes = 0x0101010101010101ull;
      if (!((~w - kOnes) & w & (kOnes << 7))) {
        const int n = (64 - left) >> 3;  // whole bytes that fit: 1..8
        buf = n == 8 ? w : (buf << (8 * n)) | (w >> (64 - 8 * n));
        left += 8 * n;
        pos += n;
        continue;
      }
      const int b = data[pos];
      if (b == 0xFF) {
        if (data[pos + 1] != 0) return false;
        pos += 2;
      } else {
        pos += 1;
      }
      buf = (buf << 8) | static_cast<uint64_t>(b);
      left += 8;
    }
    return true;
  };
  // one Huffman symbol; the caller has made at least 32 bits ready
  auto symbol = [&](const HuffTable& t) {
    const int look = static_cast<int>((buf >> (left - kLookBits)) &
                                      ((1 << kLookBits) - 1));
    uint16_t entry = t.lookup[look];
    if (entry & kSubTable) {
      const int next = static_cast<int>((buf >> (left - 16)) &
                                        ((1 << (16 - kLookBits)) - 1));
      entry = t.sub[entry & ~kSubTable][next];
    }
    left -= entry >> 8;
    return entry & 0xFF;
  };
  auto bits = [&](int n) {
    left -= n;
    return static_cast<int>((buf >> left) & ((1u << n) - 1));
  };

  if (left < 32 && !refill()) return false;
  int s = symbol(dc_[c->td]);
  if (s) s = extend(bits(s), s);
  const int dc = static_cast<int>(static_cast<unsigned>(c->dc_pred) +
                                  static_cast<unsigned>(s));
  block[0] = static_cast<int16_t>(dc);
  const HuffTable& ac = ac_[c->ta];
  for (int k = 1; k < 64; ++k) {
    if (left < 32 && !refill()) {
      std::memset(block, 0, 64 * sizeof(int16_t));
      return false;
    }
    const int rs = symbol(ac);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNaturalOrder[k]] = static_cast<int16_t>(extend(bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  c->dc_pred = dc;
  bit_buf_ = buf;
  bits_left_ = left;
  src_->pos = pos;
  return true;
}

// Advance past the RSTn marker; reset the DC predictions; clear the
// insufficient-data flag unless a marker (such as the fake EOI) is still
// in the way.
void Decoder::process_restart() {
  bits_left_ = 0;
  if (unread_marker_ == 0) next_marker();
  if (unread_marker_ == 0xD0 + next_restart_num_) {
    unread_marker_ = 0;
  } else {
    resync_to_restart(next_restart_num_);
  }
  next_restart_num_ = (next_restart_num_ + 1) & 7;
  for (int i = 0; i < ncomp_; ++i) comp_[i].dc_pred = 0;
  restarts_to_go_ = restart_interval_;
  if (unread_marker_ == 0) insufficient_ = false;
}

// jdmarker.c's jpeg_resync_to_restart.
void Decoder::resync_to_restart(int desired) {
  int marker = unread_marker_;
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;  // invalid marker: scan on
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;  // a valid non-restart marker: leave it
    } else if (marker == 0xD0 + ((desired + 1) & 7) ||
               marker == 0xD0 + ((desired + 2) & 7)) {
      action = 3;  // one of the next two restarts
    } else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7)) {
      action = 2;  // a prior restart: scan on
    } else {
      action = 1;  // the desired one, or too far away
    }
    if (action == 1) {
      unread_marker_ = 0;
      return;
    }
    if (action == 3) return;
    next_marker();
    marker = unread_marker_;
  }
}

bool Decoder::decode_scan() {
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    if (!qdefined_[c.tq]) return false;
    for (int k = 0; k < 64; ++k)
      c.quant[k] = static_cast<int16_t>(qtab_[c.tq][k]);  // ISLOW_MULT_TYPE
    c.dc_pred = 0;
  }
  for (int slot = 0; slot < 2; ++slot) {
    if (!dc_[slot].defined) {
      HuffTable& t = dc_[slot];
      std::memcpy(t.bits + 1, kStdDcBits[slot], 16);
      for (int i = 0; i < 12; ++i) t.vals[i] = static_cast<uint8_t>(i);
      t.defined = true;
    }
    if (!ac_[slot].defined) {
      HuffTable& t = ac_[slot];
      std::memcpy(t.bits + 1, kStdAcBits[slot], 16);
      std::memcpy(t.vals, kStdAcVals[slot], 162);
      t.defined = true;
    }
  }
  for (int i = 0; i < ncomp_; ++i) {
    const Component& c = comp_[i];
    if (!build_table(&dc_[c.td], true) || !build_table(&ac_[c.ta], false))
      return false;
  }
  int mcus_x, mcus_y;
  if (ncomp_ == 1) {
    mcus_x = (comp_[0].dw + 7) / 8;
    mcus_y = (comp_[0].dh + 7) / 8;
  } else {
    mcus_x = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
  }
  for (int i = 0; i < ncomp_; ++i) {
    Component& c = comp_[i];
    c.stride = mcus_x * c.h * 8;
    c.plane.assign(static_cast<size_t>(c.stride) * mcus_y * c.v * 8, 0);
  }
  restarts_to_go_ = restart_interval_;
  insufficient_ = false;
  bit_buf_ = 0;
  bits_left_ = 0;
  int16_t block[64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval_ && restarts_to_go_ == 0) process_restart();
      // out of data: the MCU stays all zero.  The MCU in which the data
      // runs out is decoded to its end on zero bits.
      const bool decode = !insufficient_;
      for (int si = 0; si < ncomp_; ++si) {
        Component& c = comp_[scan_order_[si]];
        for (int by = 0; by < c.v; ++by) {
          for (int bx = 0; bx < c.h; ++bx) {
            std::memset(block, 0, sizeof(block));
            if (decode &&
                (unread_marker_ != 0 ||
                 src_->pos + kFastMargin > src_->bytes.size() ||
                 !decode_block_fast(&c, block)))
              decode_block(&c, block);
            const int x0 = (mx * c.h + bx) * 8;
            const int y0 = (my * c.v + by) * 8;
            idct_block(block, c.quant,
                       c.plane.data() + static_cast<size_t>(y0) * c.stride + x0,
                       c.stride);
          }
        }
      }
      if (restart_interval_) --restarts_to_go_;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// inverse DCT: jidctint.c's jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2),
// at the integer widths of libjpeg-turbo's x86 SIMD version of it
// (jidctint-sse2/avx2), which is what the libjpeg under cv2 and PIL runs:
// coefficients are dequantized in 16 bits, the sums in0 +- in4, in7 + in3
// and in5 + in1 wrap in 16 bits, pass 1 saturates its outputs to 16 bits,
// and pass 2 saturates to [-128, 127] before the +128 level shift (the C
// version's range-limit table would wrap values beyond +-384 instead).  On
// coefficients that an encoder writes, both agree to the bit; they part
// only on data that ends early or is corrupt.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int wrap16(int v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v));
}

inline int saturate(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 1-D pass over 8 lanes at once: lane j transforms x[0..7][j] into
// out[0..7][j], each output descaled by n and saturated to [lo, hi].  The
// products are those of jpeg_idct_islow regrouped in pairs, as the SIMD
// version takes them, and the sums are kept in 32 bits (wrapping, as its
// lanes do; unsigned here, so the wrap is defined), then DESCALE rounds
// half up and shifts arithmetically.  Plain loops over the lanes, which
// the compiler may vectorize.
inline void idct_pass(const int32_t x[8][8], int32_t out[8][8], int n, int lo,
                      int hi) {
  using u32 = uint32_t;
  const u32 round = u32{1} << (n - 1);
  for (int j = 0; j < 8; ++j) {
    // even part
    const u32 x0 = static_cast<u32>(x[0][j]), x1 = static_cast<u32>(x[1][j]);
    const u32 x2 = static_cast<u32>(x[2][j]), x3 = static_cast<u32>(x[3][j]);
    const u32 x4 = static_cast<u32>(x[4][j]), x5 = static_cast<u32>(x[5][j]);
    const u32 x6 = static_cast<u32>(x[6][j]), x7 = static_cast<u32>(x[7][j]);
    const u32 tmp3 = x2 * u32(FIX_0_541196100 + FIX_0_765366865) +
                     x6 * u32(FIX_0_541196100);
    const u32 tmp2 = x2 * u32(FIX_0_541196100) +
                     x6 * u32(FIX_0_541196100 - FIX_1_847759065);
    const u32 tmp0 = static_cast<u32>(wrap16(static_cast<int>(x0 + x4))) << kConstBits;
    const u32 tmp1 = static_cast<u32>(wrap16(static_cast<int>(x0 - x4))) << kConstBits;
    const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    // odd part: z3 = in7 + in3, z4 = in5 + in1, z5 folded into both
    const u32 z3 = static_cast<u32>(wrap16(static_cast<int>(x7 + x3)));
    const u32 z4 = static_cast<u32>(wrap16(static_cast<int>(x5 + x1)));
    const u32 z3s = z3 * u32(FIX_1_175875602 - FIX_1_961570560) +
                    z4 * u32(FIX_1_175875602);
    const u32 z4s = z3 * u32(FIX_1_175875602) +
                    z4 * u32(FIX_1_175875602 - FIX_0_390180644);
    const u32 t0 = x7 * u32(FIX_0_298631336 - FIX_0_899976223) -
                   x1 * u32(FIX_0_899976223) + z3s;
    const u32 t3 = x1 * u32(FIX_1_501321110 - FIX_0_899976223) -
                   x7 * u32(FIX_0_899976223) + z4s;
    const u32 t1 = x5 * u32(FIX_2_053119869 - FIX_2_562915447) -
                   x3 * u32(FIX_2_562915447) + z4s;
    const u32 t2 = x3 * u32(FIX_3_072711026 - FIX_2_562915447) -
                   x5 * u32(FIX_2_562915447) + z3s;
    const u32 y[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
    for (int r = 0; r < 8; ++r)
      out[r][j] = saturate(static_cast<int32_t>(y[r] + round) >> n, lo, hi);
  }
}

void Decoder::idct_block(const int16_t* coef, const int16_t* quant,
                         uint8_t* out, int stride) const {
  int32_t x[8][8], ws[8][8], t[8][8];
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
  bool dc_only = ac_zero;
  for (int i = 1; i < 8 && dc_only; ++i) dc_only = coef[i] == 0;
  if (dc_only) {
    // the two passes below, worked out for a lone DC: one flat value
    const int32_t d = wrap16(wrap16(coef[0] * quant[0]) * (1 << kPass1Bits));
    const int n = kConstBits + kPass1Bits + 3;
    const int v = saturate(((d << kConstBits) + (1 << (n - 1))) >> n, -128, 127);
    for (int r = 0; r < 8; ++r)
      std::memset(out + static_cast<size_t>(r) * stride, v + 128, 8);
    return;
  }
  if (ac_zero) {
    // every AC coefficient of the rows below the first zero: pass 1 is
    // row 0 shifted up, in 16 bits
    for (int c = 0; c < 8; ++c)
      t[c][0] = wrap16(wrap16(coef[c] * quant[c]) * (1 << kPass1Bits));
    for (int c = 0; c < 8; ++c)
      for (int r = 1; r < 8; ++r) t[c][r] = t[c][0];
  } else {
    // pass 1: columns (lane = column), scaled up by 2**PASS1_BITS,
    // saturated to 16 bits
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        x[r][c] = wrap16(coef[r * 8 + c] * quant[r * 8 + c]);  // DEQUANTIZE
    idct_pass(x, ws, kConstBits - kPass1Bits, -32768, 32767);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) t[c][r] = ws[r][c];
  }
  // pass 2: rows (lane = row), descaled by 8 and 2**PASS1_BITS, saturated
  // to [-128, 127], then level-shifted
  idct_pass(t, ws, kConstBits + kPass1Bits + 3, -128, 127);
  for (int r = 0; r < 8; ++r) {
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    for (int c = 0; c < 8; ++c) o[c] = static_cast<uint8_t>(ws[c][r] + 128);
  }
}

// ---------------------------------------------------------------------------
// upsampling (jdsample.c with jdmainct.c's context rows) and colour
// conversion (jdcolor.c)

// Row y of a chroma plane at full width (at least width_ samples into
// `row`, which holds 2 * dw).  2x2: the fancy triangle filter, 3/4 of the
// nearer and 1/4 of the further sample each way, the row above the first
// and below the last repeating the edge row (jdmainct.c's context rows);
// 2x1 the same across only; either replicates samples when the plane is
// at most 2 samples wide, as libjpeg does.  1x1 (4:4:4) is the plane row.
const uint8_t* Decoder::upsample_row(const Component& c, int y,
                                     uint8_t* row) const {
  const uint8_t* p = c.plane.data();
  const size_t s = static_cast<size_t>(c.stride);
  if (max_h_ == 1) return p + y * s;
  const int dw = c.dw;
  const int r = max_v_ == 1 ? y : y >> 1;
  const uint8_t* near = p + r * s;
  if (dw <= 2) {
    for (int x = 0; x < dw; ++x) row[2 * x] = row[2 * x + 1] = near[x];
    return row;
  }
  const int last = dw - 1;
  if (max_v_ == 1) {  // h2v1_fancy_upsample
    row[0] = near[0];
    row[1] = static_cast<uint8_t>((near[0] * 3 + near[1] + 2) >> 2);
    for (int x = 1; x < last; ++x) {
      const int v = near[x] * 3;
      row[2 * x] = static_cast<uint8_t>((v + near[x - 1] + 1) >> 2);
      row[2 * x + 1] = static_cast<uint8_t>((v + near[x + 1] + 2) >> 2);
    }
    row[2 * last] = static_cast<uint8_t>((near[last] * 3 + near[last - 1] + 1) >> 2);
    row[2 * last + 1] = near[last];
    return row;
  }
  // h2v2_fancy_upsample: odd output rows take the row below, even the row
  // above
  const int dh = c.dh;
  const int rf = (y & 1) ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
  const uint8_t* far = p + rf * s;
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  row[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  row[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < last; ++x) {
    next_sum = near[x + 1] * 3 + far[x + 1];
    row[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    row[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  row[2 * last] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  row[2 * last + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  return row;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void Decoder::to_rgb(uint8_t* o) const {
  const int W = width_, H = height_;
  const Component& y = comp_[0];
  if (ncomp_ == 1) {
    for (int r = 0; r < H; ++r) {
      const uint8_t* in = y.plane.data() + static_cast<size_t>(r) * y.stride;
      for (int x = 0; x < W; ++x, o += 3) o[0] = o[1] = o[2] = in[x];
    }
    return;
  }
  // build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 65536 + 0.5 truncated
  constexpr int32_t kOneHalf = 1 << 15;
  constexpr int32_t kCrR = 91881;   // FIX(1.40200)
  constexpr int32_t kCbB = 116130;  // FIX(1.77200)
  constexpr int32_t kCrG = 46802;   // FIX(0.71414)
  constexpr int32_t kCbG = 22554;   // FIX(0.34414)
  int cr_r[256], cb_b[256], g[256][2];
  for (int i = 0; i < 256; ++i) {
    const int x = i - 128;
    cr_r[i] = (kCrR * x + kOneHalf) >> 16;
    cb_b[i] = (kCbB * x + kOneHalf) >> 16;
    g[i][0] = -kCbG * x + kOneHalf;  // by Cb
    g[i][1] = -kCrG * x;             // by Cr
  }
  // sample_range_limit: clamps Y + [-227, 226] to [0, 255]
  uint8_t limit[768];
  for (int i = 0; i < 768; ++i) limit[i] = clamp255(i - 256);
  const uint8_t* lim = limit + 256;
  std::vector<uint8_t> cb_row(2 * static_cast<size_t>(comp_[1].dw) + 2);
  std::vector<uint8_t> cr_row(2 * static_cast<size_t>(comp_[2].dw) + 2);
  for (int r = 0; r < H; ++r) {
    const uint8_t* yy = y.plane.data() + static_cast<size_t>(r) * y.stride;
    const uint8_t* bb = upsample_row(comp_[1], r, cb_row.data());
    const uint8_t* rr = upsample_row(comp_[2], r, cr_row.data());
    for (int x = 0; x < W; ++x, o += 3) {
      const int lum = yy[x];
      const int cb = bb[x];
      const int cr = rr[x];
      o[0] = lim[lum + cr_r[cr]];
      o[1] = lim[lum + ((g[cb][0] + g[cr][1]) >> 16)];
      o[2] = lim[lum + cb_b[cb]];
    }
  }
}

bool Decoder::run(Source* src, long long capacity, bool* too_large) {
  src_ = src;
  if (!read_headers()) return false;
  if (capacity >= 0 &&
      static_cast<long long>(width_) * height_ * 3 > capacity) {
    *too_large = true;
    return false;
  }
  return decode_scan() && finish_markers();
}

bool read_file(const char* path, Source* src) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char chunk[65536];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    src->bytes.insert(src->bytes.end(), chunk, chunk + n);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

// Reads and decodes one file (no RGB written yet); see Decoder::run.
bool decode_file(const char* path, Decoder* dec, long long capacity = -1,
                 bool* too_large = nullptr) {
  Source src;
  if (!read_file(path, &src)) return false;
  bool large = false;
  const bool ok = dec->run(&src, capacity, &large);
  if (too_large) *too_large = large;
  return ok;
}

// Nearest-neighbour resize of `src` to a square canvas (for a frame that
// is not canvas-sized): canvas pixel (y, x) takes source pixel
// (y * h / canvas, x * w / canvas), in integers.
void fit_to_canvas(const Image& src, unsigned char* dst, int canvas) {
  for (int y = 0; y < canvas; ++y) {
    const int sy = static_cast<int>(static_cast<long long>(y) * src.h / canvas);
    for (int x = 0; x < canvas; ++x) {
      const int sx = static_cast<int>(static_cast<long long>(x) * src.w / canvas);
      const unsigned char* p =
          src.data.data() + (static_cast<size_t>(sy) * src.w + sx) * 3;
      unsigned char* q = dst + (static_cast<size_t>(y) * canvas + x) * 3;
      q[0] = p[0];
      q[1] = p[1];
      q[2] = p[2];
    }
  }
}

}  // namespace

extern "C" {

// Decode one JPEG into the caller's buffer of `capacity` bytes.  Returns 0
// (and fills *out_h, *out_w), 1 on a failed or refused decode, or 2 when
// the image does not fit.
int peclr_decode_jpeg(const char* path, unsigned char* out, int capacity,
                      int* out_h, int* out_w) {
  Decoder dec;
  bool too_large = false;
  if (!decode_file(path, &dec, capacity, &too_large)) return too_large ? 2 : 1;
  dec.to_rgb(out);
  *out_h = dec.height();
  *out_w = dec.width();
  return 0;
}

// Decode `count` JPEGs into a (count, canvas, canvas, 3) uint8 buffer with
// up to `threads` workers.  Returns the number of failed decodes; their
// frames are zeroed.
int peclr_decode_batch(const char** paths, int count, unsigned char* out,
                       int canvas, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t frame = static_cast<size_t>(canvas) * canvas * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= count) return;
      Decoder dec;
      if (!decode_file(paths[i], &dec)) {
        failures.fetch_add(1);
        std::memset(out + frame * i, 0, frame);
        continue;
      }
      if (dec.height() == canvas && dec.width() == canvas) {
        dec.to_rgb(out + frame * i);  // straight into the canvas
        continue;
      }
      Image img;
      img.h = dec.height();
      img.w = dec.width();
      img.data.resize(static_cast<size_t>(img.h) * img.w * 3);
      dec.to_rgb(img.data.data());
      fit_to_canvas(img, out + frame * i, canvas);
    }
  };

  std::vector<std::thread> pool;
  const int n = threads < count ? threads : count;
  pool.reserve(n);
  for (int t = 0; t < n; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
