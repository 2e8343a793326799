// JPEG 2000 Tier-1 of the port's host codec: the MQ arithmetic decoder
// and the EBCOT code-block decoder (ITU-T T.88 / T.800) in C++ behind a
// plain C interface (loaded with ctypes by host/native.py, which builds
// this file with g++ at first use into build/native/<hash>/libjp2t1.so;
// nothing builds at import). The plain version is host/jp2_t1.py's
// decode_block with native=False: the same state machine, the same scan
// order, the same OpenJPEG-style midpoint reconstruction for truncated
// streams.
//
// The same code as the JAX package's native Tier-1 decoder, so that the
// port's native lane gives its bits: build with the same flags
// (-O3 -march=native -fPIC -Wall -Wextra -shared). No entry point keeps
// state between calls (the context tables are built per call), so
// concurrent calls from server threads are safe.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// T.88 Table E.1 — probability state machine (spec constants).
const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH_[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

constexpr int N_CTX = 19;
constexpr int CTX_UNI = 18;
constexpr int CTX_RL = 17;

struct MQDec {
  const uint8_t* data;
  int64_t len, bp;
  uint32_t c, a;
  int ct;
  uint8_t I[N_CTX];
  uint8_t mps[N_CTX];

  void bytein() {
    uint8_t b = bp < len ? data[bp] : 0xFF;
    if (b == 0xFF) {
      uint8_t b1 = bp + 1 < len ? data[bp + 1] : 0xFF;
      if (b1 > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += uint32_t(b1) << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      uint8_t b1 = bp < len ? data[bp] : 0xFF;
      c += uint32_t(b1) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* d, int64_t n) {
    data = d;
    len = n;
    std::memset(I, 0, sizeof(I));
    std::memset(mps, 0, sizeof(mps));
    I[0] = 4;
    I[CTX_RL] = 3;
    I[CTX_UNI] = 46;
    bp = 0;
    uint8_t b = n > 0 ? d[0] : 0xFF;
    c = uint32_t(b) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(int cx) {
    int i = I[cx];
    uint32_t qe = QE[i];
    a -= qe;
    int d;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d = mps[cx];
        I[cx] = NMPS[i];
      } else {
        d = 1 - mps[cx];
        if (SWITCH_[i]) mps[cx] ^= 1;
        I[cx] = NLPS[i];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (SWITCH_[i]) mps[cx] ^= 1;
        I[cx] = NLPS[i];
      } else {
        d = mps[cx];
        I[cx] = NMPS[i];
      }
    }
    do {
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct -= 1;
    } while (!(a & 0x8000));
    return d;
  }
};

// T.800 Table D.1 zero-coding contexts, per orientation family
// (0 = LL/LH, 1 = HL, 2 = HH), indexed [h][v][d].
void build_zc(int fam, int8_t tab[3][3][5]) {
  for (int h = 0; h < 3; h++)
    for (int v = 0; v < 3; v++)
      for (int d = 0; d < 5; d++) {
        int hh = fam == 1 ? v : h;
        int vv = fam == 1 ? h : v;
        int c;
        if (fam == 2) {
          int s = h + v;
          if (d >= 3)
            c = 8;
          else if (d == 2)
            c = s >= 1 ? 7 : 6;
          else if (d == 1)
            c = s >= 2 ? 5 : (s == 1 ? 4 : 3);
          else
            c = s >= 2 ? 2 : (s == 1 ? 1 : 0);
        } else {
          if (hh == 2)
            c = 8;
          else if (hh == 1)
            c = vv >= 1 ? 7 : (d >= 1 ? 6 : 5);
          else if (vv == 2)
            c = 4;
          else if (vv == 1)
            c = 3;
          else
            c = d >= 2 ? 2 : (d == 1 ? 1 : 0);
        }
        tab[h][v][d] = (int8_t)c;
      }
}

// T.800 Table D.2 sign contexts / XOR from (H+1, V+1).
const int8_t SC_CTX[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
const int8_t SC_XOR[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};

struct T1 {
  int w, h, W2;
  std::vector<uint8_t> sig, sgn, vis, ref;
  std::vector<int64_t> mag;
  std::vector<int8_t> last;
  int8_t zc[3][3][5];
  MQDec mq;

  inline int at(int y, int x) const { return y * W2 + x; }

  inline int zc_ctx(int y, int x) const {
    int n = at(y, x);
    int hh = sig[n - 1] + sig[n + 1];
    int vv = sig[n - W2] + sig[n + W2];
    int dd = sig[n - W2 - 1] + sig[n - W2 + 1] + sig[n + W2 - 1] +
             sig[n + W2 + 1];
    return zc[hh][vv][dd];
  }

  inline int sign_decode(int y, int x) {
    int n = at(y, x);
    int hh = int(sig[n - 1]) * (1 - 2 * int(sgn[n - 1])) +
             int(sig[n + 1]) * (1 - 2 * int(sgn[n + 1]));
    int vv = int(sig[n - W2]) * (1 - 2 * int(sgn[n - W2])) +
             int(sig[n + W2]) * (1 - 2 * int(sgn[n + W2]));
    hh = hh > 0 ? 1 : (hh < 0 ? -1 : 0);
    vv = vv > 0 ? 1 : (vv < 0 ? -1 : 0);
    int bit = mq.decode(SC_CTX[hh + 1][vv + 1]);
    return bit ^ SC_XOR[hh + 1][vv + 1];
  }
};

}  // namespace

extern "C" {

// Decode one EBCOT code block into out[h*w] (int32, signed).
// fam: 0 = LL/LH, 1 = HL, 2 = HH. Returns 0 on success, -1 on bad args.
int jp2_decode_block(const uint8_t* data, int64_t len, int w, int h,
                     int numbps, int npasses, int fam, int32_t* out) {
  if (w <= 0 || h <= 0 || fam < 0 || fam > 2) return -1;
  std::memset(out, 0, sizeof(int32_t) * size_t(w) * size_t(h));
  if (numbps <= 0 || npasses <= 0) return 0;

  T1 t;
  t.w = w;
  t.h = h;
  t.W2 = w + 2;
  size_t n2 = size_t(t.W2) * size_t(h + 2);
  t.sig.assign(n2, 0);
  t.sgn.assign(n2, 0);
  t.vis.assign(n2, 0);
  t.ref.assign(n2, 0);
  t.mag.assign(n2, 0);
  t.last.assign(n2, 0);
  build_zc(fam, t.zc);
  t.mq.init(data, len);

  int plane = numbps - 1;
  int total = npasses;
  int kind = 2;  // 0 spp, 1 mrp, 2 cleanup; stream starts with cleanup
  while (total > 0 && plane >= 0) {
    int64_t bitval = int64_t(1) << plane;
    if (kind == 0) {  // significance propagation
      for (int y0 = 1; y0 <= h; y0 += 4)
        for (int x = 1; x <= w; x++)
          for (int y = y0; y < y0 + 4 && y <= h; y++) {
            int n = t.at(y, x);
            if (t.sig[n] || t.vis[n]) continue;
            int cx = t.zc_ctx(y, x);
            if (cx == 0) continue;
            t.vis[n] = 1;
            if (t.mq.decode(cx)) {
              t.sig[n] = 1;
              t.mag[n] = bitval;
              t.sgn[n] = (uint8_t)t.sign_decode(y, x);
              t.last[n] = (int8_t)plane;
            }
          }
    } else if (kind == 1) {  // magnitude refinement
      for (int y0 = 1; y0 <= h; y0 += 4)
        for (int x = 1; x <= w; x++)
          for (int y = y0; y < y0 + 4 && y <= h; y++) {
            int n = t.at(y, x);
            if (!t.sig[n] || t.vis[n]) continue;
            int cx;
            if (t.ref[n]) {
              cx = 16;
            } else {
              int W2 = t.W2;
              int nb = t.sig[n - 1] + t.sig[n + 1] + t.sig[n - W2] +
                       t.sig[n + W2] + t.sig[n - W2 - 1] +
                       t.sig[n - W2 + 1] + t.sig[n + W2 - 1] +
                       t.sig[n + W2 + 1];
              cx = nb ? 15 : 14;
            }
            t.ref[n] = 1;
            if (t.mq.decode(cx)) t.mag[n] += bitval;
            t.last[n] = (int8_t)plane;
          }
    } else {  // cleanup with run-length mode
      for (int y0 = 1; y0 <= h; y0 += 4) {
        bool full = y0 + 3 <= h;
        for (int x = 1; x <= w; x++) {
          int y = y0;
          if (full) {
            bool allclear = true;
            for (int yy = y0; yy < y0 + 4; yy++) {
              int n = t.at(yy, x);
              if (t.vis[n] || t.sig[n] || t.zc_ctx(yy, x)) {
                allclear = false;
                break;
              }
            }
            if (allclear) {
              if (!t.mq.decode(CTX_RL)) continue;
              int r = (t.mq.decode(CTX_UNI) << 1) | t.mq.decode(CTX_UNI);
              y = y0 + r;
              int n = t.at(y, x);
              t.sig[n] = 1;
              t.mag[n] = bitval;
              t.sgn[n] = (uint8_t)t.sign_decode(y, x);
              t.last[n] = (int8_t)plane;
              y += 1;
            }
          }
          for (; y < y0 + 4 && y <= h; y++) {
            int n = t.at(y, x);
            if (!t.vis[n] && !t.sig[n]) {
              if (t.mq.decode(t.zc_ctx(y, x))) {
                t.sig[n] = 1;
                t.mag[n] = bitval;
                t.sgn[n] = (uint8_t)t.sign_decode(y, x);
                t.last[n] = (int8_t)plane;
              }
            }
          }
        }
      }
      std::fill(t.vis.begin(), t.vis.end(), 0);
    }
    if (kind == 2) {
      plane -= 1;
      kind = 0;
    } else {
      kind += 1;
    }
    total -= 1;
  }

  for (int y = 1; y <= h; y++)
    for (int x = 1; x <= w; x++) {
      int n = t.at(y, x);
      int64_t m = t.mag[n];
      if (m > 0 && t.last[n] > 0) m += int64_t(1) << (t.last[n] - 1);
      out[(y - 1) * w + (x - 1)] = (int32_t)(t.sgn[n] ? -m : m);
    }
  return 0;
}

}  // extern "C"
