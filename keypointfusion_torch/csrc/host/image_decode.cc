// Host image decoders of the port's data path: PNG unfiltering and
// baseline JPEG, with cv2.imread's results (OpenCV over libpng and
// libjpeg-turbo), bit for bit.
//
// Compiled by g++ into a shared library with a plain C interface and
// bound with ctypes (keypointfusion_torch/kernels/build.py:HostLibrary);
// every entry point writes into a buffer the caller allocated and
// returns 0, KPF_CORRUPT for data that is damaged, or KPF_UNSUPPORTED for
// a valid file this decoder does not handle, with a message in `err`.
//
// PNG: the caller inflates the IDAT stream (zlib) and this undoes the
// five row filters (None, Sub, Up, Average, Paeth) for any byte depth.
//
// JPEG: baseline and extended sequential Huffman (SOF0/SOF1), 8-bit
// samples, grey or YCbCr, 4:4:4, 4:2:2 and 4:2:0, restart markers.
// The arithmetic is libjpeg-turbo's defaults, as cv2 decodes: the
// accurate integer IDCT (jidctint.c, jpeg_idct_islow) clamped as its SIMD
// code does, "fancy" triangular upsampling (jdsample.c, h2v1 and h2v2,
// with the edge rows and columns replicated), and fixed-point YCbCr to
// BGR with 16 scale bits (jdcolor.c). Data that ends early, or meets a
// marker inside a scan, decodes as libjpeg does: zero bits for the
// rest of that MCU and blank (mid-grey) MCUs after it.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int KPF_OK = 0;
constexpr int KPF_CORRUPT = 1;
constexpr int KPF_UNSUPPORTED = 2;

int fail(int code, char* err, int err_len, const char* msg) {
  if (err && err_len > 0) snprintf(err, err_len, "%s", msg);
  return code;
}

// ------------------------------------------------------------------ PNG ---

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// ----------------------------------------------------------------- JPEG ---

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // k past 63 in damaged data lands here, as in jdhuff.c
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];   // 0: code longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];                // largest code of each length, -1
  int32_t valoffset[17];
  uint8_t huffval[256];
};

bool build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals,
                   int nvals) {
  memset(h.look_len, 0, sizeof(h.look_len));
  memcpy(h.huffval, vals, nvals);
  int last = 0;
  for (int len = 1; len <= 16; ++len)
    if (bits[len - 1]) last = len;
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valoffset[len] = k - code;
    h.maxcode[len] = bits[len - 1] ? code + bits[len - 1] - 1 : -1;
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      if (len <= kLookBits) {
        int shift = kLookBits - len;
        for (int f = 0; f < (1 << shift); ++f) {
          h.look_len[(code << shift) | f] = (uint8_t)len;
          h.look_sym[(code << shift) | f] = vals[k];
        }
      }
    }
    // no code may be all ones (jdhuff.c, JERR_BAD_HUFF_TABLE)
    if (len <= last && code >= (1 << len)) return false;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;              // sentinel: stops the search
  h.defined = true;
  return true;
}

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int bw, bh;            // blocks across / down in the plane
  int dw, dh;            // downsampled width / height (real samples)
  std::vector<uint8_t> plane;
  int stride;
};

struct Decoder {
  const uint8_t* data;
  int len;
  int pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int orientation = 1;
  bool adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];

  // entropy-coded segment reader
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  int padded = 0;                 // zero bits appended after the data
  bool hit_marker = false;        // a marker or the end stopped the data
  bool insufficient = false;      // libjpeg's insufficient_data

  char* err;
  int err_len;

  int u8() { return pos < len ? data[pos++] : -1; }
  int u16() {
    if (pos + 2 > len) return -1;
    int v = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    return v;
  }

  void fill() {
    while (bitcnt <= 56) {
      int byte = 0;
      if (!hit_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          int next = pos + 1 < len ? data[pos + 1] : -1;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;   // leave the marker for the parser
            byte = 0;
          }
        } else {
          pos++;
        }
      } else {
        hit_marker = true;
      }
      if (hit_marker) {
        // zero bits in place of the missing data (jdhuff.c)
        if (bitcnt > 32) return;
        bitcnt += 8;
        padded += 8;
        bitbuf <<= 8;
        continue;
      }
      bitbuf = (bitbuf << 8) | (uint64_t)byte;
      bitcnt += 8;
    }
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    if (bitcnt < n) fill();
    int v = (int)((bitbuf >> (bitcnt - n)) & ((1u << n) - 1));
    bitcnt -= n;
    return v;
  }

  inline int decode(const Huffman& h) {
    if (bitcnt < 16) fill();
    int look = (int)((bitbuf >> (bitcnt - kLookBits)) &
                     ((1 << kLookBits) - 1));
    int l = h.look_len[look];
    if (l) {
      bitcnt -= l;
      return h.look_sym[look];
    }
    int code = look;
    bitcnt -= kLookBits;
    int len = kLookBits;
    while (code > h.maxcode[len]) {
      code = (code << 1) | bits(1);
      ++len;
    }
    if (len > 16) return 0;   // bad code: jdhuff.c returns 0 too
    return h.huffval[(code + h.valoffset[len]) & 0xFF];
  }

  static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  int parse_sof(int seglen, int marker);
  int parse_dht(int seglen);
  int parse_dqt(int seglen);
  void parse_app(int seglen, int marker);
  int scan(int seglen);
  int headers(bool stop_at_sos);
  void idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out,
                  int stride);
  void output(uint8_t* out, bool grey);
};

int be16(const uint8_t* p, bool little) {
  return little ? (p[0] | (p[1] << 8)) : ((p[0] << 8) | p[1]);
}
uint32_t be32(const uint8_t* p, bool little) {
  return little ? (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) |
                             ((uint32_t)p[3] << 24))
                : (uint32_t)(((uint32_t)p[0] << 24) | (p[1] << 16) |
                             (p[2] << 8) | p[3]);
}

void Decoder::parse_app(int seglen, int marker) {
  const uint8_t* p = data + pos;
  int n = seglen - 2;
  if (marker == 0xE1 && n >= 14 && memcmp(p, "Exif\0\0", 6) == 0) {
    // EXIF orientation (tag 0x0112 of IFD0), which cv2 applies
    const uint8_t* t = p + 6;
    int tn = n - 6;
    bool little = t[0] == 'I';
    if ((t[0] == 'I' || t[0] == 'M') && tn >= 8) {
      uint32_t ifd = be32(t + 4, little);
      if (ifd + 2 <= (uint32_t)tn) {
        int count = be16(t + ifd, little);
        for (int i = 0; i < count; ++i) {
          uint32_t e = ifd + 2 + 12 * i;
          if (e + 12 > (uint32_t)tn) break;
          if (be16(t + e, little) == 0x0112)
            orientation = be16(t + e + 8, little);
        }
      }
    }
  }
  if (marker == 0xEE && n >= 12 && memcmp(p, "Adobe", 5) == 0) {
    adobe = true;
    adobe_transform = p[11];
  }
  pos += n;
}

int Decoder::parse_sof(int seglen, int marker) {
  if (marker != 0xC0 && marker != 0xC1) {
    return fail(KPF_UNSUPPORTED, err, err_len,
         marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
                 marker == 0xCE
             ? "progressive JPEG is not supported"
         : marker >= 0xC9 ? "arithmetic-coded JPEG is not supported"
                          : "lossless or hierarchical JPEG is not supported");
  }
  if (frame || seglen < 8 || pos + seglen - 2 > len) {
    return fail(KPF_CORRUPT, err, err_len, "bad SOF segment");
  }
  int precision = data[pos];
  height = (data[pos + 1] << 8) | data[pos + 2];
  width = (data[pos + 3] << 8) | data[pos + 4];
  ncomp = data[pos + 5];
  if (precision != 8) {
    return fail(KPF_UNSUPPORTED, err, err_len,
                "only 8-bit JPEG samples are supported");
  }
  if (ncomp != 1 && ncomp != 3) {
    return fail(KPF_UNSUPPORTED, err, err_len,
         "only 1- or 3-component JPEG is supported");
  }
  if (width <= 0 || height <= 0 || seglen != 8 + 3 * ncomp) {
    return fail(KPF_CORRUPT, err, err_len, "bad SOF segment");
  }
  for (int i = 0; i < ncomp; ++i) {
    const uint8_t* c = data + pos + 6 + 3 * i;
    comp[i].id = c[0];
    comp[i].h = c[1] >> 4;
    comp[i].v = c[1] & 15;
    comp[i].tq = c[2];
    if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
        comp[i].tq > 3) {
      return fail(KPF_CORRUPT, err, err_len, "bad SOF component");
    }
    if (comp[i].h > hmax) hmax = comp[i].h;
    if (comp[i].v > vmax) vmax = comp[i].v;
  }
  for (int i = 0; i < ncomp; ++i) {
    int rh = hmax / comp[i].h, rv = vmax / comp[i].v;
    bool ok = hmax % comp[i].h == 0 && vmax % comp[i].v == 0 &&
              ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
               (rh == 2 && rv == 2));
    if (ncomp == 1) ok = true;   // one component: never upsampled
    if (!ok) {
      return fail(KPF_UNSUPPORTED, err, err_len,
           "JPEG sampling other than 4:4:4, 4:2:2 or 4:2:0");
    }
  }
  if (ncomp == 1) {
    hmax = vmax = comp[0].h = comp[0].v = 1;
  }
  mcux = (width + 8 * hmax - 1) / (8 * hmax);
  mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp[i];
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
    c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
    c.stride = c.bw * 8;
  }
  pos += seglen - 2;
  frame = true;
  return KPF_OK;
}

int Decoder::parse_dht(int seglen) {
  int end = pos + seglen - 2;
  if (end > len) return fail(KPF_CORRUPT, err, err_len, "bad DHT");
  while (pos < end) {
    int tc_th = data[pos++];
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3 || pos + 16 > end)
      return fail(KPF_CORRUPT, err, err_len, "bad DHT");
    const uint8_t* counts = data + pos;
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i];
    pos += 16;
    if (total > 256 || pos + total > end)
      return fail(KPF_CORRUPT, err, err_len, "bad DHT");
    Huffman& h = tc == 0 ? dc[th] : ac[th];
    if (!build_huffman(h, counts, data + pos, total))
      return fail(KPF_CORRUPT, err, err_len, "bad Huffman table");
    pos += total;
  }
  return KPF_OK;
}

int Decoder::parse_dqt(int seglen) {
  int end = pos + seglen - 2;
  if (end > len) return fail(KPF_CORRUPT, err, err_len, "bad DQT");
  while (pos < end) {
    int pq_tq = data[pos++];
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (pq > 1 || tq > 3 || pos + 64 * (pq + 1) > end)
      return fail(KPF_CORRUPT, err, err_len, "bad DQT");
    for (int k = 0; k < 64; ++k) {
      int v = pq ? (data[pos + 2 * k] << 8) | data[pos + 2 * k + 1]
                 : data[pos + k];
      qt[tq][kZigzag[k]] = (uint16_t)v;
    }
    qt_defined[tq] = true;
    pos += 64 * (pq + 1);
  }
  return KPF_OK;
}

// jidctint.c's jpeg_idct_islow; the output clamped to [0, 255] as
// libjpeg-turbo's SIMD code does it (saturating packs).
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;
}
inline uint8_t clamp_sample(int32_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void Decoder::idct_block(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int32_t dcval = (int32_t)(ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    constexpr int n = CONST_BITS + PASS1_BITS + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = clamp_sample(descale(wp[0], PASS1_BITS + 3));
      memset(op, v, 8);
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_sample(descale(tmp10 + tmp3, n));
    op[7] = clamp_sample(descale(tmp10 - tmp3, n));
    op[1] = clamp_sample(descale(tmp11 + tmp2, n));
    op[6] = clamp_sample(descale(tmp11 - tmp2, n));
    op[2] = clamp_sample(descale(tmp12 + tmp1, n));
    op[5] = clamp_sample(descale(tmp12 - tmp1, n));
    op[3] = clamp_sample(descale(tmp13 + tmp0, n));
    op[4] = clamp_sample(descale(tmp13 - tmp0, n));
  }
}

// One scan: its header at pos, then the entropy-coded data. Returns
// KPF_OK with pos at the marker that ends the scan.
int Decoder::scan(int seglen) {
  if (!frame) return fail(KPF_CORRUPT, err, err_len, "SOS before SOF");
  if (pos + seglen - 2 > len)
    return fail(KPF_CORRUPT, err, err_len, "bad SOS");
  int ns = data[pos];
  if (ns < 1 || ns > ncomp || seglen != 6 + 2 * ns)
    return fail(KPF_CORRUPT, err, err_len, "bad SOS");
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = data[pos + 1 + 2 * i], t = data[pos + 2 + 2 * i];
    sc[i] = nullptr;
    for (int c = 0; c < ncomp; ++c)
      if (comp[c].id == id) sc[i] = &comp[c];
    if (!sc[i]) return fail(KPF_CORRUPT, err, err_len, "bad SOS component");
    sc[i]->dc_tbl = t >> 4;
    sc[i]->ac_tbl = t & 15;
    if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3 ||
        !dc[sc[i]->dc_tbl].defined || !ac[sc[i]->ac_tbl].defined)
      return fail(KPF_CORRUPT, err, err_len, "undefined Huffman table");
    if (!qt_defined[sc[i]->tq])
      return fail(KPF_CORRUPT, err, err_len, "undefined quantization table");
  }
  int ss = data[pos + 1 + 2 * ns], se = data[pos + 2 + 2 * ns];
  int ahal = data[pos + 3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0)
    return fail(KPF_CORRUPT, err, err_len, "bad spectral selection");
  pos += seglen - 2;
  for (int i = 0; i < ns; ++i) {
    Component& c = *sc[i];
    if (c.plane.empty()) c.plane.assign((size_t)c.stride * c.bh * 8, 0);
  }

  // MCU geometry: interleaved scans take each component's h x v blocks;
  // a one-component scan takes one block at a time over the component's
  // own block grid (ceil(dw / 8) x ceil(dh / 8)).
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = mcux;
    units_y = mcuy;
  }
  int total = units_x * units_y;
  int dc_pred[3] = {0, 0, 0};
  bitbuf = 0;
  bitcnt = 0;
  padded = 0;
  hit_marker = false;
  insufficient = false;
  int16_t block[64];
  int next_restart = restart_interval;
  int expected_rst = 0;
  for (int m = 0; m < total; ++m) {
    if (restart_interval && m > 0 && m == next_restart) {
      // restart: drop the partial byte, expect RSTn, reset predictions
      next_restart += restart_interval;
      bitbuf = 0;
      bitcnt = 0;
      padded = 0;
      hit_marker = false;
      while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0 &&
                                data[pos + 1] != 0xFF))
        ++pos;
      if (pos + 1 < len && data[pos + 1] == 0xD0 + expected_rst) {
        pos += 2;
        insufficient = false;
      }
      expected_rst = (expected_rst + 1) & 7;
      dc_pred[0] = dc_pred[1] = dc_pred[2] = 0;
    }
    int ux = m % units_x, uy = m / units_x;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          memset(block, 0, sizeof(block));
          if (!insufficient) {
            int s = decode(dc[c.dc_tbl]);
            int diff = s ? extend(bits(s), s) : 0;
            dc_pred[i] += diff;
            block[0] = (int16_t)dc_pred[i];
            const Huffman& a = ac[c.ac_tbl];
            for (int k = 1; k < 64; ++k) {
              int rs = decode(a);
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                int v = extend(bits(sz), sz);
                block[kZigzag[k]] = (int16_t)v;
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
          int x = ns == 1 ? ux : ux * c.h + bx;
          int y = ns == 1 ? uy : uy * c.v + by;
          idct_block(block, qt[c.tq], c.plane.data() + (size_t)y * 8 *
                     c.stride + x * 8, c.stride);
        }
      }
    }
    // the MCU that read past the data is kept; those after it are blank
    if (bitcnt < padded) insufficient = true;
  }
  // leave pos at the next marker
  while (pos + 1 < len &&
         !(data[pos] == 0xFF && data[pos + 1] != 0 && data[pos + 1] != 0xFF))
    ++pos;
  return KPF_OK;
}

int Decoder::headers(bool stop_at_sos) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
    return fail(KPF_CORRUPT, err, err_len, "not a JPEG file");
  pos = 2;
  bool scanned = false;
  while (true) {
    // find the next marker, skipping fill bytes
    int b = u8();
    while (b != -1 && b != 0xFF) b = u8();
    while (b == 0xFF) b = u8();
    if (b == -1) {
      if (scanned) return KPF_OK;   // no EOI: as libjpeg, a warning
      return fail(KPF_CORRUPT, err, err_len, "no image data in JPEG");
    }
    int marker = b;
    if (marker == 0xD9) {
      if (!scanned) return fail(KPF_CORRUPT, err, err_len, "no scan");
      return KPF_OK;
    }
    if (marker >= 0xD0 && marker <= 0xD7) continue;
    if (marker == 0x01) continue;
    int seglen = u16();
    if (seglen < 2 || pos + seglen - 2 > len)
      return fail(KPF_CORRUPT, err, err_len, "truncated JPEG segment");
    if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      int rc = parse_sof(seglen, marker);
      if (rc != KPF_OK) return rc;
    } else if (marker == 0xC4) {
      int rc = parse_dht(seglen);
      if (rc != KPF_OK) return rc;
    } else if (marker == 0xCC) {
      return fail(KPF_UNSUPPORTED, err, err_len,
                  "arithmetic-coded JPEG is not supported");
    } else if (marker == 0xDB) {
      int rc = parse_dqt(seglen);
      if (rc != KPF_OK) return rc;
    } else if (marker == 0xDD) {
      if (seglen != 4) return fail(KPF_CORRUPT, err, err_len, "bad DRI");
      restart_interval = u16();
    } else if (marker == 0xDA) {
      // three components stored as RGB, not YCbCr (libjpeg's rule)
      if (ncomp == 3 && ((adobe && adobe_transform == 0) ||
                         (!adobe && comp[0].id == 'R' && comp[1].id == 'G' &&
                          comp[2].id == 'B')))
        return fail(KPF_UNSUPPORTED, err, err_len,
                    "an RGB-coded JPEG (no YCbCr transform) is not "
                    "supported");
      if (stop_at_sos) {
        if (!frame) return fail(KPF_CORRUPT, err, err_len, "SOS before SOF");
        return KPF_OK;
      }
      int rc = scan(seglen);
      if (rc != KPF_OK) return rc;
      scanned = true;
    } else if (marker >= 0xE0 && marker <= 0xEF) {
      parse_app(seglen, marker);
    } else {
      pos += seglen - 2;   // COM, DNL and others
    }
  }
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// The component's samples at full size for output row y: a copy, or
// jdsample.c's fancy upsampling (h2v1, h2v2 with the rows above and below
// clamped to the real rows, as jdmainct.c replicates them).
void upsample_row(const Component& c, int rh, int rv, int y, int width,
                  uint8_t* out) {
  if (rh == 1 && rv == 1) {
    memcpy(out, c.plane.data() + (size_t)y * c.stride, width);
    return;
  }
  int iy = rv == 2 ? y >> 1 : y;
  const uint8_t* in0 = c.plane.data() + (size_t)iy * c.stride;
  int dw = c.dw;
  if (dw <= 2) {   // jdsample.c: no fancy upsampling this narrow
    for (int x = 0; x < width; ++x) out[x] = in0[x >> 1];
    return;
  }
  std::vector<uint8_t> tmp;
  uint8_t stack_buf[4096];
  uint8_t* o = 2 * dw <= (int)sizeof(stack_buf)
                   ? stack_buf
                   : (tmp.resize(2 * dw), tmp.data());
  if (rv == 1) {
    o[0] = in0[0];
    o[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; ++i) {
      int v = in0[i] * 3;
      o[2 * i] = (uint8_t)((v + in0[i - 1] + 1) >> 2);
      o[2 * i + 1] = (uint8_t)((v + in0[i + 1] + 2) >> 2);
    }
    int v = in0[dw - 1];
    o[2 * dw - 2] = (uint8_t)((v * 3 + in0[dw - 2] + 1) >> 2);
    o[2 * dw - 1] = (uint8_t)v;
  } else {
    int ny = (y & 1) ? iy + 1 : iy - 1;
    if (ny < 0) ny = 0;
    if (ny > c.dh - 1) ny = c.dh - 1;
    const uint8_t* in1 = c.plane.data() + (size_t)ny * c.stride;
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
    o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; ++i) {
      next_sum = in0[i + 1] * 3 + in1[i + 1];
      o[2 * i] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * i + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  }
  memcpy(out, o, width);
}

// jdcolor.c's tables, 16 scale bits
struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = (int32_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) {
      return (int32_t)(x * (1L << SCALEBITS) + 0.5);
    };
    for (int i = 0, x = -128; i <= 255; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

void Decoder::output(uint8_t* out, bool grey) {
  if (ncomp == 1 || grey) {
    const Component& c = comp[0];
    int rh = hmax / c.h, rv = vmax / c.v;
    std::vector<uint8_t> row(width + 16);
    for (int y = 0; y < height; ++y) {
      upsample_row(c, rh, rv, y, width, row.data());
      if (grey) {
        memcpy(out + (size_t)y * width, row.data(), width);
      } else {
        uint8_t* o = out + (size_t)y * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = row[x];
      }
    }
    return;
  }
  const ColorTables& t = color_tables();
  std::vector<uint8_t> r0(width + 16), r1(width + 16), r2(width + 16);
  for (int y = 0; y < height; ++y) {
    upsample_row(comp[0], hmax / comp[0].h, vmax / comp[0].v, y, width,
                 r0.data());
    upsample_row(comp[1], hmax / comp[1].h, vmax / comp[1].v, y, width,
                 r1.data());
    upsample_row(comp[2], hmax / comp[2].h, vmax / comp[2].v, y, width,
                 r2.data());
    uint8_t* o = out + (size_t)y * width * 3;
    for (int x = 0; x < width; ++x) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x + 2] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

}  // namespace

// Undo the PNG row filters of `height` rows of `row_bytes` bytes, each
// row preceded by its filter type byte in `raw` (the inflated IDAT
// stream, at least height * (row_bytes + 1) bytes); `bpp` is the bytes per
// pixel (at least 1). Writes height * row_bytes bytes to `out`.
extern "C" int kpf_png_unfilter(const unsigned char* raw, int raw_len,
                                int height, int row_bytes, int bpp,
                                unsigned char* out, char* err, int err_len) {
  if ((long long)height * (row_bytes + 1) > raw_len)
    return fail(KPF_CORRUPT, err, err_len, "PNG: not enough image data");
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + (size_t)y * (row_bytes + 1);
    int type = in[0];
    ++in;
    uint8_t* o = out + (size_t)y * row_bytes;
    const uint8_t* prev = y ? o - row_bytes : nullptr;
    switch (type) {
      case 0:
        memcpy(o, in, row_bytes);
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i)
          o[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          o[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return fail(KPF_CORRUPT, err, err_len, "PNG: bad filter type");
    }
  }
  return KPF_OK;
}

// The frame of a JPEG: info = [width, height, components, EXIF
// orientation (1 when absent)].
extern "C" int kpf_jpeg_info(const unsigned char* data, int len, int* info,
                             char* err, int err_len) {
  Decoder d;
  d.data = data;
  d.len = len;
  d.err = err;
  d.err_len = err_len;
  int rc = d.headers(true);
  if (rc != KPF_OK) return rc;
  info[0] = d.width;
  info[1] = d.height;
  info[2] = d.ncomp;
  info[3] = d.orientation;
  return KPF_OK;
}

// Decode a JPEG into `out`: height x width x 3 bytes in BGR order, or
// height x width grey bytes (the Y component) when `grey` is not 0.
extern "C" int kpf_jpeg_decode(const unsigned char* data, int len,
                               int grey, unsigned char* out, char* err,
                               int err_len) {
  Decoder d;
  d.data = data;
  d.len = len;
  d.err = err;
  d.err_len = err_len;
  int rc = d.headers(false);
  if (rc != KPF_OK) return rc;
  for (int i = 0; i < d.ncomp; ++i)
    if (d.comp[i].plane.empty())
      d.comp[i].plane.assign((size_t)d.comp[i].stride * d.comp[i].bh * 8,
                             128);   // never scanned: mid-grey
  d.output(out, grey != 0);
  return KPF_OK;
}
