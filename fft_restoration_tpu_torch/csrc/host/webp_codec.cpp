// WebP decode of the port's host codec: VP8 key frames, VP8L lossless
// and ALPH alpha planes, in C++ behind a plain C interface (loaded with
// ctypes by host/native.py, which builds this file with g++ at first use
// into build/native/<hash>/libwebpdec.so; nothing builds at import). The
// NumPy/Python decoders of host/webp.py and host/webp_vp8.py (RFC 6386
// and the WebP Lossless Bitstream Specification) are the plain versions
// of every entry point here, reached with native=False; a non-zero
// return here raises in host/webp.py, it never runs the plain lane in
// its place.
//
// The same code as the JAX package's native WebP decoder, so that the
// port's native lane gives its bits: build with the same flags
// (-O3 -march=native -fPIC -Wall -Wextra -shared). No entry point keeps
// state between calls (the helpers marked static are functions, the
// tables are const), so concurrent calls from server threads are safe.
//
// Spec constants (quantizer lookups, zigzag, bands, token trees, the
// LZ77 distance map) are embedded; the three large default probability
// tables (coefficient / update / key-frame B-mode) are passed in from
// host/_vp8_tables.py so both lanes share one copy.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct DecErr {};  // internal abort -> extern "C" returns nonzero

[[noreturn]] inline void fail() { throw DecErr{}; }

// ===========================================================================
// VP8L (lossless)
// ===========================================================================

struct LsbBitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t pos;  // bit position

  uint32_t read_bits(int n) {
    int64_t p = pos;
    pos = p + n;
    int64_t byte = p >> 3;
    if (byte + 8 > nbytes) {
      uint32_t v = 0;
      for (int i = 0; i < n; i++) {
        int64_t b = (p + i) >> 3;
        if (b >= nbytes) fail();
        v |= uint32_t((data[b] >> ((p + i) & 7)) & 1) << i;
      }
      return v;
    }
    uint64_t window;
    std::memcpy(&window, data + byte, 8);  // little-endian load
    return uint32_t((window >> (p & 7)) & ((uint64_t(1) << n) - 1));
  }

  int read_bit() {
    int64_t p = pos;
    pos = p + 1;
    int64_t byte = p >> 3;
    if (byte >= nbytes) fail();
    return (data[byte] >> (p & 7)) & 1;
  }

  // peek up to 8 bits (callers guarantee bits_left() >= 8, so a 2-byte
  // window always exists; the 4-byte fast load needs 4 in-bounds bytes)
  uint32_t peek8() const {
    int64_t byte = pos >> 3;
    if (byte + 4 <= nbytes) {
      uint32_t w;
      std::memcpy(&w, data + byte, 4);
      return (w >> (pos & 7)) & 0xFF;
    }
    uint32_t w = 0;
    for (int i = 0; i < 3; i++)
      if (byte + i < nbytes) w |= uint32_t(data[byte + i]) << (8 * i);
    return (w >> (pos & 7)) & 0xFF;
  }
  int64_t bits_left() const { return nbytes * 8 - pos; }
};

// Canonical Huffman (VP8L): MSB-first code bits from the LSB-first
// stream. Root-8 lookup table; longer codes fall back to per-length
// first/count/offset decoding.
struct Huffman {
  // root[v] = (sym << 8) | len for len <= 8, or 0xFFFFFFFF sentinel
  std::vector<uint32_t> root;
  // slow path (codes longer than 8 bits)
  int max_len = 0;
  int32_t first[16];    // first canonical code of each length
  int32_t count[16];    // number of codes of each length
  int32_t offset[16];   // index into syms of first code of each length
  std::vector<int32_t> syms;
  int32_t single = -1;  // single-symbol tree: 0 bits consumed

  void build(const int32_t* lengths, int n) {
    int nz = 0, last = -1;
    int32_t bl_count[16] = {0};
    max_len = 0;
    for (int i = 0; i < n; i++) {
      if (lengths[i] > 0) {
        if (lengths[i] > 15) fail();
        nz++;
        last = i;
        bl_count[lengths[i]]++;
        if (lengths[i] > max_len) max_len = lengths[i];
      }
    }
    if (nz == 0) fail();
    if (nz == 1) {
      single = last;
      return;
    }
    int64_t code = 0;
    int32_t next_code[17] = {0};
    for (int ln = 1; ln <= max_len; ln++) {
      code = (code + bl_count[ln - 1]) << 1;
      next_code[ln] = int32_t(code);
      first[ln] = int32_t(code);
      count[ln] = bl_count[ln];
    }
    // per-length symbol lists (canonical order = symbol order)
    int32_t off = 0;
    for (int ln = 1; ln <= max_len; ln++) {
      offset[ln] = off;
      off += count[ln];
    }
    syms.assign(off, 0);
    std::vector<int32_t> fill(max_len + 1);
    for (int ln = 1; ln <= max_len; ln++) fill[ln] = offset[ln];
    root.assign(256, 0xFFFFFFFFu);
    for (int s = 0; s < n; s++) {
      int ln = lengths[s];
      if (!ln) continue;
      int32_t c = next_code[ln]++;
      syms[fill[ln]++] = s;
      if (ln <= 8) {
        // stream-order index: bit j of index = code bit (ln-1-j)
        uint32_t base = 0;
        for (int j = 0; j < ln; j++)
          base |= uint32_t((c >> (ln - 1 - j)) & 1) << j;
        for (uint32_t f = 0; f < (1u << (8 - ln)); f++)
          root[base | (f << ln)] = (uint32_t(s) << 8) | uint32_t(ln);
      }
    }
  }

  // full bitwise read: the canonical walk over all lengths (used when
  // the root table misses — code longer than 8 bits — or within 8 bits
  // of stream end, where peeking a whole byte is not possible)
  int32_t read_tail(LsbBitReader& br) const {
    int32_t code = 0;
    for (int ln = 1; ln <= max_len; ln++) {
      code = (code << 1) | br.read_bit();
      int32_t idx = code - first[ln];
      if (idx >= 0 && idx < count[ln]) return syms[offset[ln] + idx];
    }
    fail();
  }
};

// the read() above skips lengths <= 8 in its slow loop (they are only
// reachable near stream end) — route those through read_tail instead.
inline int32_t huff_read(const Huffman& h, LsbBitReader& br) {
  if (h.single >= 0) return h.single;
  if (br.bits_left() >= 8) {
    uint32_t e = h.root[br.peek8()];
    if (e != 0xFFFFFFFFu) {
      br.pos += e & 0xFF;
      return int32_t(e >> 8);
    }
    // code longer than 8 bits: finish with the canonical walk
    return h.read_tail(br);
  }
  return h.read_tail(br);
}

const int kClOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16,
                          6,  7,  8, 9, 10, 11, 12, 13, 14, 15};

void read_code_lengths(LsbBitReader& br, int num_symbols,
                       std::vector<int32_t>& lengths) {
  int num_codes = 4 + int(br.read_bits(4));
  int32_t cl_lengths[19] = {0};
  for (int i = 0; i < num_codes; i++)
    cl_lengths[kClOrder[i]] = int32_t(br.read_bits(3));
  Huffman cl_tree;
  cl_tree.build(cl_lengths, 19);

  lengths.assign(num_symbols, 0);
  int64_t max_symbol;
  if (br.read_bit()) {
    int length_nbits = 2 + 2 * int(br.read_bits(3));
    max_symbol = 2 + br.read_bits(length_nbits);
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0;
  int prev_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol <= 0) break;
    max_symbol--;
    int32_t code = huff_read(cl_tree, br);
    if (code < 16) {
      lengths[symbol++] = code;
      if (code) prev_len = code;
    } else {
      int repeat, fill;
      if (code == 16) {
        repeat = 3 + int(br.read_bits(2));
        fill = prev_len;
      } else if (code == 17) {
        repeat = 3 + int(br.read_bits(3));
        fill = 0;
      } else {
        repeat = 11 + int(br.read_bits(7));
        fill = 0;
      }
      if (symbol + repeat > num_symbols) fail();
      for (int i = 0; i < repeat; i++) lengths[symbol++] = fill;
    }
  }
}

void read_huffman_code(LsbBitReader& br, int alphabet_size, Huffman& h) {
  if (br.read_bit()) {  // simple code
    int num_symbols = int(br.read_bits(1)) + 1;
    int sym0 = br.read_bit() ? int(br.read_bits(8)) : int(br.read_bits(1));
    std::vector<int32_t> lengths(alphabet_size, 0);
    if (num_symbols == 1) {
      if (sym0 >= alphabet_size) fail();
      h.single = sym0;
      return;
    }
    int sym1 = int(br.read_bits(8));
    if (sym0 >= alphabet_size || sym1 >= alphabet_size || sym0 == sym1)
      fail();
    lengths[sym0] = 1;
    lengths[sym1] = 1;
    h.build(lengths.data(), alphabet_size);
    return;
  }
  std::vector<int32_t> lengths;
  read_code_lengths(br, alphabet_size, lengths);
  h.build(lengths.data(), alphabet_size);
}

// LZ77 2D distance map (WebP Lossless spec 5.2.2) — (x, y) offsets
const int8_t kDistMap[120][2] = {
    {0, 1}, {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1}, {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1}, {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4}, {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2}, {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5}, {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4}, {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6}, {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5}, {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7}, {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6}, {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7}, {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0}, {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3}, {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6}, {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7},
};

inline int64_t plane_code_to_distance(int xsize, int64_t plane_code) {
  if (plane_code > 120) return plane_code - 120;
  int x = kDistMap[plane_code - 1][0];
  int y = kDistMap[plane_code - 1][1];
  int64_t dist = int64_t(y) * xsize + x;
  return dist >= 1 ? dist : 1;
}

inline int64_t get_copy_length(LsbBitReader& br, int prefix_sym) {
  if (prefix_sym < 4) return prefix_sym + 1;
  int extra = (prefix_sym - 2) >> 1;
  int64_t offset = int64_t(2 + (prefix_sym & 1)) << extra;
  return offset + br.read_bits(extra) + 1;
}

constexpr uint32_t kHashMul = 0x1E35A7BDu;

struct Transform {
  int type;
  int bits;                    // predictor / color / color-indexing xbits
  std::vector<uint32_t> img;   // tile image or palette
  int tw = 0, th = 0;          // tile image dims
  int true_xsize = 0;          // color-indexing original width
};

struct VP8LDecoder {
  LsbBitReader br;

  std::vector<uint32_t> decode_image_stream(int xsize, int ysize,
                                            bool is_level0,
                                            std::vector<Transform>* tfs) {
    int cur_xsize = xsize;
    std::vector<Transform> local;
    std::vector<Transform>& transforms = tfs ? *tfs : local;
    if (is_level0) {
      uint32_t seen = 0;
      while (br.read_bit()) {
        int ttype = int(br.read_bits(2));
        if (seen & (1u << ttype)) fail();
        seen |= 1u << ttype;
        cur_xsize = read_transform(ttype, cur_xsize, ysize, transforms);
      }
    }
    int cache_bits = br.read_bit() ? int(br.read_bits(4)) : 0;
    if (cache_bits > 11) fail();

    std::vector<int64_t> meta;  // group index per meta-tile
    int meta_bits = 0, mw = 0;
    int num_groups = 1;
    if (is_level0 && br.read_bit()) {
      meta_bits = int(br.read_bits(3)) + 2;
      mw = (cur_xsize + (1 << meta_bits) - 1) >> meta_bits;
      int mh = (ysize + (1 << meta_bits) - 1) >> meta_bits;
      std::vector<uint32_t> mimg =
          decode_image_stream(mw, mh, false, nullptr);
      meta.resize(int64_t(mw) * mh);
      int64_t mx = 0;
      for (int64_t i = 0; i < int64_t(mw) * mh; i++) {
        meta[i] = (mimg[i] >> 8) & 0xFFFF;
        if (meta[i] + 1 > mx) mx = meta[i] + 1;
      }
      num_groups = int(mx);
    }

    int green_size = 256 + 24 + (cache_bits ? (1 << cache_bits) : 0);
    std::vector<Huffman> trees(size_t(num_groups) * 5);
    for (int g = 0; g < num_groups; g++) {
      read_huffman_code(br, green_size, trees[g * 5 + 0]);
      read_huffman_code(br, 256, trees[g * 5 + 1]);  // red
      read_huffman_code(br, 256, trees[g * 5 + 2]);  // blue
      read_huffman_code(br, 256, trees[g * 5 + 3]);  // alpha
      read_huffman_code(br, 40, trees[g * 5 + 4]);   // distance
    }

    std::vector<uint32_t> argb = decode_pixels(
        cur_xsize, ysize, trees, num_groups,
        meta.empty() ? nullptr : meta.data(), mw, meta_bits, cache_bits);

    for (int64_t t = int64_t(transforms.size()) - 1; t >= 0; t--) {
      apply_inverse_transform(transforms[t], argb, cur_xsize, ysize);
    }
    return argb;
  }

  int read_transform(int ttype, int xsize, int ysize,
                     std::vector<Transform>& transforms) {
    if (ttype == 0 || ttype == 1) {  // PREDICTOR / COLOR
      Transform tf;
      tf.type = ttype;
      tf.bits = int(br.read_bits(3)) + 2;
      tf.tw = (xsize + (1 << tf.bits) - 1) >> tf.bits;
      tf.th = (ysize + (1 << tf.bits) - 1) >> tf.bits;
      tf.img = decode_image_stream(tf.tw, tf.th, false, nullptr);
      transforms.push_back(std::move(tf));
    } else if (ttype == 2) {  // SUBTRACT_GREEN
      Transform tf;
      tf.type = 2;
      transforms.push_back(std::move(tf));
    } else if (ttype == 3) {  // COLOR_INDEXING
      int n = int(br.read_bits(8)) + 1;
      std::vector<uint32_t> palette = decode_image_stream(n, 1, false,
                                                          nullptr);
      // palette entries stored as per-channel deltas mod 256
      for (int i = 1; i < n; i++) {
        uint32_t p = palette[i], q = palette[i - 1];
        uint32_t out = 0;
        for (int c = 0; c < 4; c++) {
          uint32_t a = (p >> (8 * c)) & 0xFF, b = (q >> (8 * c)) & 0xFF;
          out |= ((a + b) & 0xFF) << (8 * c);
        }
        palette[i] = out;
      }
      int xbits = n > 16 ? 0 : (n > 4 ? 1 : (n > 2 ? 2 : 3));
      int full = 1 << (8 >> xbits);
      if (int(palette.size()) < full) palette.resize(full, 0);
      Transform tf;
      tf.type = 3;
      tf.bits = xbits;
      tf.img = std::move(palette);
      tf.true_xsize = xsize;
      transforms.push_back(std::move(tf));
      return (xsize + (1 << xbits) - 1) >> xbits;
    } else {
      fail();
    }
    return xsize;
  }

  std::vector<uint32_t> decode_pixels(int xsize, int ysize,
                                      const std::vector<Huffman>& trees,
                                      int num_groups, const int64_t* meta,
                                      int mw, int meta_bits,
                                      int cache_bits) {
    int64_t n = int64_t(xsize) * ysize;
    std::vector<uint32_t> out(n, 0);
    std::vector<uint32_t> cache;
    int cache_shift = 0;
    if (cache_bits) {
      cache.assign(size_t(1) << cache_bits, 0);
      cache_shift = 32 - cache_bits;
    }
    const Huffman* grp = &trees[0];
    bool single_group = (meta == nullptr);
    int64_t pos = 0;
    int x = 0;
    while (pos < n) {
      if (!single_group) {
        int64_t y_m = (pos / xsize) >> meta_bits;
        int64_t x_m = x >> meta_bits;
        int64_t g = meta[y_m * mw + x_m];
        if (g >= num_groups) fail();
        grp = &trees[size_t(g) * 5];
      }
      int32_t s = huff_read(grp[0], br);
      if (s < 256) {
        uint32_t red = uint32_t(huff_read(grp[1], br));
        uint32_t blue = uint32_t(huff_read(grp[2], br));
        uint32_t alpha = uint32_t(huff_read(grp[3], br));
        uint32_t px = (alpha << 24) | (red << 16) | (uint32_t(s) << 8) | blue;
        out[pos] = px;
        if (cache_bits) cache[(px * kHashMul) >> cache_shift] = px;
        pos++;
        if (++x == xsize) x = 0;
      } else if (s < 256 + 24) {
        int64_t length = get_copy_length(br, s - 256);
        int32_t dsym = huff_read(grp[4], br);
        int64_t dcode = get_copy_length(br, dsym);
        int64_t dist = plane_code_to_distance(xsize, dcode);
        if (dist > pos || pos + length > n) fail();
        for (int64_t i = 0; i < length; i++) out[pos + i] = out[pos + i - dist];
        if (cache_bits) {
          for (int64_t i = 0; i < length; i++) {
            uint32_t px = out[pos + i];
            cache[(px * kHashMul) >> cache_shift] = px;
          }
        }
        pos += length;
        x = int(pos % xsize);
      } else {
        if (!cache_bits) fail();
        out[pos] = cache[s - 256 - 24];
        pos++;
        if (++x == xsize) x = 0;
      }
    }
    return out;
  }

  // ---- inverse transforms (mutate argb; may change xsize via resize) ----

  static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    // per-channel (a + b) & 0xFF
    uint32_t rb = ((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu;
    uint32_t ga = ((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u;
    return rb | ga;
  }

  static inline uint32_t avg2px(uint32_t a, uint32_t b) {
    // per-channel (a + b) >> 1
    uint32_t out = 0;
    for (int c = 0; c < 32; c += 8) {
      uint32_t v = (((a >> c) & 0xFF) + ((b >> c) & 0xFF)) >> 1;
      out |= v << c;
    }
    return out;
  }

  static inline uint32_t clip255u(int v) {
    return v < 0 ? 0u : (v > 255 ? 255u : uint32_t(v));
  }

  void apply_inverse_transform(const Transform& tf,
                               std::vector<uint32_t>& argb, int& xsize,
                               int ysize) {
    if (tf.type == 2) {  // subtract green
      for (auto& px : argb) {
        uint32_t g = (px >> 8) & 0xFF;
        uint32_t r = (((px >> 16) & 0xFF) + g) & 0xFF;
        uint32_t b = ((px & 0xFF) + g) & 0xFF;
        px = (px & 0xFF00FF00u) | (r << 16) | b;
      }
      return;
    }
    if (tf.type == 1) {  // color transform
      for (int y = 0; y < ysize; y++) {
        const uint32_t* trow = &tf.img[size_t(y >> tf.bits) * tf.tw];
        uint32_t* row = &argb[size_t(y) * xsize];
        for (int x = 0; x < xsize; x++) {
          uint32_t t = trow[x >> tf.bits];
          int g2r = int8_t(t & 0xFF);
          int g2b = int8_t((t >> 8) & 0xFF);
          int r2b = int8_t((t >> 16) & 0xFF);
          uint32_t px = row[x];
          int g = int8_t((px >> 8) & 0xFF);
          int64_t r = (px >> 16) & 0xFF;
          int64_t b = px & 0xFF;
          r = (r + ((int64_t(g2r) * g) >> 5)) & 0xFF;
          int r8 = int8_t(r);
          b = (b + ((int64_t(g2b) * g) >> 5)) & 0xFF;
          b = (b + ((int64_t(r2b) * r8) >> 5)) & 0xFF;
          row[x] = (px & 0xFF00FF00u) | (uint32_t(r) << 16) | uint32_t(b);
        }
      }
      return;
    }
    if (tf.type == 0) {  // predictor
      predictor_inverse(argb, tf, xsize, ysize);
      return;
    }
    if (tf.type == 3) {  // color indexing
      int xbits = tf.bits;
      int true_xsize = tf.true_xsize;
      const std::vector<uint32_t>& palette = tf.img;
      std::vector<uint32_t> out(size_t(true_xsize) * ysize);
      if (xbits == 0) {
        // palette pre-expanded to 1 << 8 entries above: any index is safe
        for (int64_t i = 0; i < int64_t(xsize) * ysize; i++)
          out[i] = palette[(argb[i] >> 8) & 0xFF];
      } else {
        int per = 1 << xbits;
        int bits_per = 8 >> xbits;
        uint32_t mask = (1u << bits_per) - 1;
        for (int y = 0; y < ysize; y++) {
          const uint32_t* row = &argb[size_t(y) * xsize];
          uint32_t* orow = &out[size_t(y) * true_xsize];
          for (int x = 0; x < true_xsize; x++) {
            uint32_t green = (row[x / per] >> 8) & 0xFF;
            uint32_t idx = (green >> (bits_per * (x % per))) & mask;
            orow[x] = palette[idx];
          }
        }
      }
      argb = std::move(out);
      xsize = true_xsize;
      return;
    }
    fail();
  }

  void predictor_inverse(std::vector<uint32_t>& argb, const Transform& tf,
                         int xsize, int ysize) {
    int bits = tf.bits;
    for (int y = 0; y < ysize; y++) {
      uint32_t* row = &argb[size_t(y) * xsize];
      const uint32_t* trow = y > 0 ? &argb[size_t(y - 1) * xsize] : nullptr;
      const uint32_t* modes = &tf.img[size_t(y >> bits) * tf.tw];
      for (int x = 0; x < xsize; x++) {
        uint32_t pred;
        if (x == 0 && y == 0) {
          pred = 0xFF000000u;
        } else if (y == 0) {
          pred = row[x - 1];
        } else if (x == 0) {
          pred = trow[x];
        } else {
          int mode = int((modes[x >> bits] >> 8) & 0xFF);
          uint32_t L = row[x - 1];
          uint32_t T = trow[x];
          uint32_t TL = trow[x - 1];
          uint32_t TR = x + 1 < xsize ? trow[x + 1] : row[0];
          switch (mode) {
            case 0: pred = 0xFF000000u; break;
            case 1: pred = L; break;
            case 2: pred = T; break;
            case 3: pred = TR; break;
            case 4: pred = TL; break;
            case 5: pred = avg2px(avg2px(L, TR), T); break;
            case 6: pred = avg2px(L, TL); break;
            case 7: pred = avg2px(L, T); break;
            case 8: pred = avg2px(TL, T); break;
            case 9: pred = avg2px(T, TR); break;
            case 10: pred = avg2px(avg2px(L, TL), avg2px(T, TR)); break;
            case 11: {  // Select
              int pab = 0;
              for (int c = 0; c < 32; c += 8) {
                int l = (L >> c) & 0xFF, t = (T >> c) & 0xFF,
                    tl = (TL >> c) & 0xFF;
                pab += (l > tl ? l - tl : tl - l) - (t > tl ? t - tl : tl - t);
              }
              pred = pab <= 0 ? T : L;
              break;
            }
            case 12: {  // ClampedAddSubtractFull
              pred = 0;
              for (int c = 0; c < 32; c += 8) {
                int v = int((L >> c) & 0xFF) + int((T >> c) & 0xFF) -
                        int((TL >> c) & 0xFF);
                pred |= clip255u(v) << c;
              }
              break;
            }
            case 13: {  // ClampedAddSubtractHalf
              pred = 0;
              for (int c = 0; c < 32; c += 8) {
                int ave = (int((L >> c) & 0xFF) + int((T >> c) & 0xFF)) >> 1;
                int d = ave - int((TL >> c) & 0xFF);
                int half = d >= 0 ? (d >> 1) : -((-d) >> 1);
                pred |= clip255u(ave + half) << c;
              }
              break;
            }
            default: fail();
          }
        }
        row[x] = add_pixels(row[x], pred);
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// extern "C" VP8L entry points
// ---------------------------------------------------------------------------

extern "C" int webp_vp8l_decode(const uint8_t* data, int64_t n, int w,
                                int h, uint8_t* rgba_out) {
  try {
    VP8LDecoder dec;
    dec.br = {data, n, 0};
    if (dec.br.read_bits(8) != 0x2F) return 1;
    int sw = int(dec.br.read_bits(14)) + 1;
    int sh = int(dec.br.read_bits(14)) + 1;
    if (sw != w || sh != h) return 1;
    dec.br.read_bits(1);             // alpha hint
    if (dec.br.read_bits(3) != 0) return 1;  // version
    std::vector<uint32_t> argb = dec.decode_image_stream(w, h, true,
                                                         nullptr);
    if (int64_t(argb.size()) != int64_t(w) * h) return 1;
    for (int64_t i = 0; i < int64_t(w) * h; i++) {
      uint32_t px = argb[i];
      rgba_out[4 * i + 0] = uint8_t((px >> 16) & 0xFF);  // R
      rgba_out[4 * i + 1] = uint8_t((px >> 8) & 0xFF);   // G
      rgba_out[4 * i + 2] = uint8_t(px & 0xFF);          // B
      rgba_out[4 * i + 3] = uint8_t(px >> 24);           // A
    }
    return 0;
  } catch (...) {
    return 1;
  }
}

// ALPH chunk: full flag parsing + method 0/1 + filters 0-3
extern "C" int webp_alpha_decode(const uint8_t* data, int64_t n, int w,
                                 int h, uint8_t* a_out) {
  try {
    if (n < 1) return 1;
    int flags = data[0];
    int method = flags & 0x3;
    int filt = (flags >> 2) & 0x3;
    std::vector<uint8_t> a(size_t(w) * h);
    if (method == 0) {
      if (n - 1 < int64_t(w) * h) return 1;
      std::memcpy(a.data(), data + 1, size_t(w) * h);
    } else {
      VP8LDecoder dec;
      dec.br = {data + 1, n - 1, 0};
      std::vector<uint32_t> argb =
          dec.decode_image_stream(w, h, true, nullptr);
      if (int64_t(argb.size()) != int64_t(w) * h) return 1;
      for (int64_t i = 0; i < int64_t(w) * h; i++)
        a[i] = uint8_t((argb[i] >> 8) & 0xFF);
    }
    if (filt) {
      if (filt == 1) {  // horizontal
        for (int y = 0; y < h; y++) {
          uint8_t* row = &a[size_t(y) * w];
          if (y > 0) row[0] = uint8_t(row[0] + a[size_t(y - 1) * w]);
          for (int x = 1; x < w; x++) row[x] = uint8_t(row[x] + row[x - 1]);
        }
      } else if (filt == 2) {  // vertical
        for (int x = 1; x < w; x++) a[x] = uint8_t(a[x] + a[x - 1]);
        for (int y = 1; y < h; y++) {
          uint8_t* row = &a[size_t(y) * w];
          const uint8_t* prow = &a[size_t(y - 1) * w];
          for (int x = 0; x < w; x++) row[x] = uint8_t(row[x] + prow[x]);
        }
      } else {  // gradient
        for (int y = 0; y < h; y++) {
          uint8_t* row = &a[size_t(y) * w];
          const uint8_t* prow = y > 0 ? &a[size_t(y - 1) * w] : nullptr;
          for (int x = 0; x < w; x++) {
            int p;
            if (x == 0 && y == 0) p = 0;
            else if (y == 0) p = row[x - 1];
            else if (x == 0) p = prow[x];
            else {
              int g = int(row[x - 1]) + int(prow[x]) - int(prow[x - 1]);
              p = g < 0 ? 0 : (g > 255 ? 255 : g);
            }
            row[x] = uint8_t(row[x] + p);
          }
        }
      }
    }
    std::memcpy(a_out, a.data(), size_t(w) * h);
    return 0;
  } catch (...) {
    return 1;
  }
}

// ===========================================================================
// VP8 (lossy keyframe) — host/webp_vp8.py's decoder (RFC 6386 intra path)
// ===========================================================================

namespace {

// libwebp common_dec.h mode ids (16x16/chroma modes alias: DC=0,TM=1,VE=2,HE=3)
enum { M_DC = 0, M_TM, M_VE, M_HE, M_RD, M_VR, M_LD, M_VL, M_HD, M_HU };

const uint16_t kDcQ[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,
    17,  17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,
    25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,
    38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,
    51,  52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,
    65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  76,  77,
    78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,  91,  93,
    95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
    154, 157};
const uint16_t kAcQ[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,
    18,  19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,
    32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,
    46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,
    62,  64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,
    90,  92,  94,  96,  98,  100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284};
const int kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const int8_t kBmodeTree[18] = {0, 1, -1, 2,  -2, 3,  4,  6,  -3,
                               5, -4, -5, -6, 7,  -7, 8,  -8, -9};
const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCatProbs1[] = {159};
const uint8_t kCatProbs2[] = {165, 145};
const uint8_t kCatProbs3[] = {173, 148, 140};
const uint8_t kCatProbs4[] = {176, 155, 140, 135};
const uint8_t kCatProbs5[] = {180, 157, 141, 134, 130};
const uint8_t kCatProbs6[] = {254, 254, 243, 230, 196, 177,
                              153, 140, 133, 130, 129};
const uint8_t* kCatProbs[6] = {kCatProbs1, kCatProbs2, kCatProbs3,
                               kCatProbs4, kCatProbs5, kCatProbs6};
const int kCatLen[6] = {1, 2, 3, 4, 5, 11};
const int kCatBase[6] = {5, 7, 11, 19, 35, 67};

struct BoolDecoder {
  const uint8_t* data = nullptr;
  int64_t n = 0;
  uint32_t value = 0;
  uint32_t range = 255;
  int bits = 0;
  int64_t pos = 2;

  void init(const uint8_t* d, int64_t len) {
    data = d;
    n = len;
    value = 0;
    for (int i = 0; i < 2; i++)
      value = (value << 8) | (i < len ? d[i] : 0);
    range = 255;
    bits = 0;
    pos = 2;
  }

  int get_bit(int prob) {
    uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    if (range < 128) {
      do {
        range <<= 1;
        value <<= 1;
        if (++bits == 8) {
          bits = 0;
          if (pos < n) value |= data[pos];
          pos++;
        }
      } while (range < 128);
    }
    return bit;
  }

  int get_literal(int nb) {
    int v = 0;
    for (int i = 0; i < nb; i++) v = (v << 1) | get_bit(128);
    return v;
  }
  int get_signed(int nb) {
    int v = get_literal(nb);
    return get_bit(128) ? -v : v;
  }
  int get_flagged_signed(int nb) {
    return get_bit(128) ? get_signed(nb) : 0;
  }
};

// ---- inverse transforms ----

inline int64_t vp8_mul1(int64_t a) { return ((a * 20091) >> 16) + a; }
inline int64_t vp8_mul2(int64_t a) { return (a * 35468) >> 16; }

void idct4x4(const int32_t* c16, int32_t* out /*4x4*/) {
  int64_t t[4][4];
  for (int ci = 0; ci < 4; ci++) {
    int64_t m0 = c16[ci], m1 = c16[4 + ci], m2 = c16[8 + ci],
            m3 = c16[12 + ci];
    int64_t a = m0 + m2;
    int64_t b = m0 - m2;
    int64_t c = vp8_mul2(m1) - vp8_mul1(m3);
    int64_t d = vp8_mul1(m1) + vp8_mul2(m3);
    t[0][ci] = a + d;
    t[1][ci] = b + c;
    t[2][ci] = b - c;
    t[3][ci] = a - d;
  }
  for (int i = 0; i < 4; i++) {
    int64_t u0 = t[i][0], u1 = t[i][1], u2 = t[i][2], u3 = t[i][3];
    int64_t dc = u0 + 4;
    int64_t a2 = dc + u2;
    int64_t b2 = dc - u2;
    int64_t c2 = vp8_mul2(u1) - vp8_mul1(u3);
    int64_t d2 = vp8_mul1(u1) + vp8_mul2(u3);
    out[4 * i + 0] = int32_t((a2 + d2) >> 3);
    out[4 * i + 1] = int32_t((b2 + c2) >> 3);
    out[4 * i + 2] = int32_t((b2 - c2) >> 3);
    out[4 * i + 3] = int32_t((a2 - d2) >> 3);
  }
}

void iwht4x4(const int32_t* c16, int32_t* out /*16 dcs*/) {
  int64_t t[4][4];
  for (int ci = 0; ci < 4; ci++) {
    int64_t m0 = c16[ci], m1 = c16[4 + ci], m2 = c16[8 + ci],
            m3 = c16[12 + ci];
    int64_t a0 = m0 + m3;
    int64_t a1 = m1 + m2;
    int64_t a2 = m1 - m2;
    int64_t a3 = m0 - m3;
    t[0][ci] = a0 + a1;
    t[2][ci] = a0 - a1;
    t[1][ci] = a3 + a2;
    t[3][ci] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    int64_t dc = t[i][0] + 3;
    int64_t b0 = dc + t[i][3];
    int64_t b1 = t[i][1] + t[i][2];
    int64_t b2 = t[i][1] - t[i][2];
    int64_t b3 = dc - t[i][3];
    out[4 * i + 0] = int32_t((b0 + b1) >> 3);
    out[4 * i + 1] = int32_t((b3 + b2) >> 3);
    out[4 * i + 2] = int32_t((b0 - b1) >> 3);
    out[4 * i + 3] = int32_t((b3 - b2) >> 3);
  }
}

// ---- intra predictors ----

inline int avg2r(int a, int b) { return (a + b + 1) >> 1; }
inline int avg3r(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline uint8_t clip255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// whole-block (16x16 / 8x8) predictor into pred[size*size]
void pred_block(int mode, const uint8_t* top, const uint8_t* left_col,
                int left_stride, int tl, int size, bool have_top,
                bool have_left, int32_t* pred) {
  if (mode == M_DC) {
    int dc;
    int ts = 0, ls = 0;
    for (int i = 0; i < size; i++) {
      ts += top[i];
      ls += left_col[i * left_stride];
    }
    if (have_top && have_left)
      dc = (ts + ls + size) >> (size == 16 ? 5 : 4);
    else if (have_left)
      dc = (ls + (size >> 1)) >> (size == 16 ? 4 : 3);
    else if (have_top)
      dc = (ts + (size >> 1)) >> (size == 16 ? 4 : 3);
    else
      dc = 0x80;
    for (int i = 0; i < size * size; i++) pred[i] = dc;
    return;
  }
  if (mode == M_VE) {
    for (int y = 0; y < size; y++)
      for (int x = 0; x < size; x++) pred[y * size + x] = top[x];
    return;
  }
  if (mode == M_HE) {
    for (int y = 0; y < size; y++) {
      int v = left_col[y * left_stride];
      for (int x = 0; x < size; x++) pred[y * size + x] = v;
    }
    return;
  }
  // TM
  for (int y = 0; y < size; y++) {
    int l = left_col[y * left_stride];
    for (int x = 0; x < size; x++) {
      int v = l + top[x] - tl;
      pred[y * size + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
  }
}

// 4x4 predictor; top/left/tr len-4 ints, tl scalar
void pred4(int mode, const int* t, const int* tr, const int* l, int x,
           int32_t* o /*4x4*/) {
  int t0 = t[0], t1 = t[1], t2 = t[2], t3 = t[3];
  int l0 = l[0], l1 = l[1], l2 = l[2], l3 = l[3];
  int r0 = tr[0], r1 = tr[1], r2 = tr[2], r3 = tr[3];
  switch (mode) {
    case M_DC: {
      int dc = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3;
      for (int i = 0; i < 16; i++) o[i] = dc;
      break;
    }
    case M_TM:
      for (int y = 0; y < 4; y++) {
        int lv = l[y];
        for (int xx = 0; xx < 4; xx++) {
          int v = lv + t[xx] - x;
          o[4 * y + xx] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
      }
      break;
    case M_VE: {
      int row[4] = {avg3r(x, t0, t1), avg3r(t0, t1, t2), avg3r(t1, t2, t3),
                    avg3r(t2, t3, r0)};
      for (int y = 0; y < 4; y++)
        for (int xx = 0; xx < 4; xx++) o[4 * y + xx] = row[xx];
      break;
    }
    case M_HE: {
      int col[4] = {avg3r(x, l0, l1), avg3r(l0, l1, l2), avg3r(l1, l2, l3),
                    avg3r(l2, l3, l3)};
      for (int y = 0; y < 4; y++)
        for (int xx = 0; xx < 4; xx++) o[4 * y + xx] = col[y];
      break;
    }
    case M_RD:
      o[12] = avg3r(l1, l2, l3);
      o[8] = o[13] = avg3r(l0, l1, l2);
      o[4] = o[9] = o[14] = avg3r(x, l0, l1);
      o[0] = o[5] = o[10] = o[15] = avg3r(t0, x, l0);
      o[1] = o[6] = o[11] = avg3r(t1, t0, x);
      o[2] = o[7] = avg3r(t2, t1, t0);
      o[3] = avg3r(t3, t2, t1);
      break;
    case M_LD:
      o[0] = avg3r(t0, t1, t2);
      o[1] = o[4] = avg3r(t1, t2, t3);
      o[2] = o[5] = o[8] = avg3r(t2, t3, r0);
      o[3] = o[6] = o[9] = o[12] = avg3r(t3, r0, r1);
      o[7] = o[10] = o[13] = avg3r(r0, r1, r2);
      o[11] = o[14] = avg3r(r1, r2, r3);
      o[15] = avg3r(r2, r3, r3);
      break;
    case M_VR:
      o[0] = o[9] = avg2r(x, t0);
      o[1] = o[10] = avg2r(t0, t1);
      o[2] = o[11] = avg2r(t1, t2);
      o[3] = avg2r(t2, t3);
      o[12] = avg3r(l2, l1, l0);
      o[8] = avg3r(l1, l0, x);
      o[4] = o[13] = avg3r(l0, x, t0);
      o[5] = o[14] = avg3r(x, t0, t1);
      o[6] = o[15] = avg3r(t0, t1, t2);
      o[7] = avg3r(t1, t2, t3);
      break;
    case M_VL:
      o[0] = avg2r(t0, t1);
      o[1] = o[8] = avg2r(t1, t2);
      o[2] = o[9] = avg2r(t2, t3);
      o[3] = o[10] = avg2r(t3, r0);
      o[4] = avg3r(t0, t1, t2);
      o[5] = o[12] = avg3r(t1, t2, t3);
      o[6] = o[13] = avg3r(t2, t3, r0);
      o[7] = o[14] = avg3r(t3, r0, r1);
      o[11] = avg3r(r0, r1, r2);
      o[15] = avg3r(r1, r2, r3);
      break;
    case M_HD:
      o[0] = o[6] = avg2r(x, l0);
      o[4] = o[10] = avg2r(l0, l1);
      o[8] = o[14] = avg2r(l1, l2);
      o[12] = avg2r(l2, l3);
      o[3] = avg3r(t0, t1, t2);
      o[2] = avg3r(x, t0, t1);
      o[1] = o[7] = avg3r(l0, x, t0);
      o[5] = o[11] = avg3r(x, l0, l1);
      o[9] = o[15] = avg3r(l0, l1, l2);
      o[13] = avg3r(l1, l2, l3);
      break;
    default:  // M_HU
      o[0] = avg2r(l0, l1);
      o[1] = avg3r(l0, l1, l2);
      o[2] = o[4] = avg2r(l1, l2);
      o[3] = o[5] = avg3r(l1, l2, l3);
      o[6] = o[8] = avg2r(l2, l3);
      o[7] = o[9] = avg3r(l2, l3, l3);
      o[10] = o[11] = o[12] = o[13] = o[14] = o[15] = l3;
      break;
  }
}

// ---- loop filter (per lane; host/webp_vp8.py runs it vectorized) ----

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

struct EdgeTaps {
  uint8_t* p;   // pointer to tap q0 of this lane
  int step;     // byte step between taps (1 = row window, stride = column)
};

inline bool needs_filter2_lane(const EdgeTaps& e, int thresh, int ithresh) {
  int p3 = e.p[-4 * e.step], p2 = e.p[-3 * e.step], p1 = e.p[-2 * e.step],
      p0 = e.p[-1 * e.step];
  int q0 = e.p[0], q1 = e.p[1 * e.step], q2 = e.p[2 * e.step],
      q3 = e.p[3 * e.step];
  if (4 * (p0 > q0 ? p0 - q0 : q0 - p0) + (p1 > q1 ? p1 - q1 : q1 - p1) >
      2 * thresh + 1)
    return false;
  auto ad = [](int a, int b) { return a > b ? a - b : b - a; };
  return ad(p3, p2) <= ithresh && ad(p2, p1) <= ithresh &&
         ad(p1, p0) <= ithresh && ad(q3, q2) <= ithresh &&
         ad(q2, q1) <= ithresh && ad(q1, q0) <= ithresh;
}

inline bool hev_lane(const EdgeTaps& e, int thresh) {
  int p1 = e.p[-2 * e.step], p0 = e.p[-1 * e.step];
  int q0 = e.p[0], q1 = e.p[1 * e.step];
  auto ad = [](int a, int b) { return a > b ? a - b : b - a; };
  return ad(p1, p0) > thresh || ad(q1, q0) > thresh;
}

inline void do_filter2_lane(const EdgeTaps& e) {
  int p1 = e.p[-2 * e.step], p0 = e.p[-1 * e.step];
  int q0 = e.p[0], q1 = e.p[1 * e.step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  e.p[-1 * e.step] = clip255(p0 + a2);
  e.p[0] = clip255(q0 - a1);
}

inline void do_filter4_lane(const EdgeTaps& e) {
  int p1 = e.p[-2 * e.step], p0 = e.p[-1 * e.step];
  int q0 = e.p[0], q1 = e.p[1 * e.step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  e.p[-2 * e.step] = clip255(p1 + a3);
  e.p[-1 * e.step] = clip255(p0 + a2);
  e.p[0] = clip255(q0 - a1);
  e.p[1 * e.step] = clip255(q1 - a3);
}

inline void do_filter6_lane(const EdgeTaps& e) {
  int p2 = e.p[-3 * e.step], p1 = e.p[-2 * e.step], p0 = e.p[-1 * e.step];
  int q0 = e.p[0], q1 = e.p[1 * e.step], q2 = e.p[2 * e.step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7;
  int a2 = (18 * a + 63) >> 7;
  int a3 = (9 * a + 63) >> 7;
  e.p[-3 * e.step] = clip255(p2 + a3);
  e.p[-2 * e.step] = clip255(p1 + a2);
  e.p[-1 * e.step] = clip255(p0 + a1);
  e.p[0] = clip255(q0 - a1);
  e.p[1 * e.step] = clip255(q1 - a2);
  e.p[2 * e.step] = clip255(q2 - a3);
}

// filter one edge across `nlanes` lanes.  horizontal=false: vertical
// edge, taps along a row (step 1), lanes advance by stride.
// horizontal=true: horizontal edge, taps along a column (step stride),
// lanes advance by 1.
void filter_edge(uint8_t* plane, int64_t stride, int64_t lane0,
                 int64_t edge_pos, int nlanes, int thresh, int ithresh,
                 int hev_t, bool mb_edge, bool horizontal) {
  for (int i = 0; i < nlanes; i++) {
    EdgeTaps e;
    if (horizontal) {
      e.p = plane + edge_pos * stride + (lane0 + i);
      e.step = int(stride);
    } else {
      e.p = plane + (lane0 + i) * stride + edge_pos;
      e.step = 1;
    }
    if (!needs_filter2_lane(e, thresh, ithresh)) continue;
    if (hev_lane(e, hev_t)) {
      do_filter2_lane(e);
    } else if (mb_edge) {
      do_filter6_lane(e);
    } else {
      do_filter4_lane(e);
    }
  }
}

void filter_edge_simple(uint8_t* plane, int64_t stride, int64_t lane0,
                        int64_t edge_pos, int nlanes, int thresh,
                        bool horizontal) {
  for (int i = 0; i < nlanes; i++) {
    uint8_t* p;
    int step;
    if (horizontal) {
      p = plane + edge_pos * stride + (lane0 + i);
      step = int(stride);
    } else {
      p = plane + (lane0 + i) * stride + edge_pos;
      step = 1;
    }
    int p1 = p[-2 * step], p0 = p[-1 * step], q0 = p[0], q1 = p[1 * step];
    if (4 * (p0 > q0 ? p0 - q0 : q0 - p0) +
            (p1 > q1 ? p1 - q1 : q1 - p1) >
        2 * thresh + 1)
      continue;
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    p[-1 * step] = clip255(p0 + a2);
    p[0] = clip255(q0 - a1);
  }
}

// ---- fancy upsample + YUV->RGB ----

inline void yuv_to_rgb_px(int y, int u, int v, uint8_t* out) {
  int yg = (y * 19077) >> 8;
  int r = (yg + ((v * 26149) >> 8) - 14234) >> 6;
  int g = (yg - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708) >> 6;
  int b = (yg + ((u * 33050) >> 8) - 17685) >> 6;
  out[0] = clip255(r);
  out[1] = clip255(g);
  out[2] = clip255(b);
}

// one output row of fancy-upsampled chroma (exact port of _blend_row)
void blend_row(const uint8_t* top_uv, const uint8_t* cur_uv, int uv_w,
               int w, int32_t* out) {
  out[0] = (3 * top_uv[0] + cur_uv[0] + 2) >> 2;
  for (int xx = 0; xx + 1 < uv_w; xx++) {
    int tl = top_uv[xx], t = top_uv[xx + 1];
    int l = cur_uv[xx], c = cur_uv[xx + 1];
    int avg = tl + t + l + c + 8;
    int diag12 = (avg + 2 * (t + l)) >> 3;
    int diag03 = (avg + 2 * (tl + c)) >> 3;
    if (2 * xx + 1 < w) out[2 * xx + 1] = (diag12 + tl) >> 1;
    if (2 * xx + 2 < w) out[2 * xx + 2] = (diag03 + t) >> 1;
  }
  if (!(w & 1))
    out[w - 1] = (3 * top_uv[uv_w - 1] + cur_uv[uv_w - 1] + 2) >> 2;
}

// ---- coefficient decoding ----

// decode one 4x4 block's tokens; returns end position n
int get_coeffs(BoolDecoder& bd, const uint8_t* probs_t /*8*3*11*/, int ctx,
               int first, int dq_dc, int dq_ac, int32_t* out /*16*/) {
  int n = first;
  const uint8_t* p = probs_t + (kBands[n] * 3 + ctx) * 11;
  while (n < 16) {
    if (!bd.get_bit(p[0])) return n;
    while (!bd.get_bit(p[1])) {  // DCT_0 run
      if (++n == 16) return 16;
      p = probs_t + (kBands[n] * 3 + 0) * 11;
    }
    int v, nctx;
    if (!bd.get_bit(p[2])) {
      v = 1;
      nctx = 1;
    } else {
      nctx = 2;
      if (!bd.get_bit(p[3])) {
        v = !bd.get_bit(p[4]) ? 2 : 3 + bd.get_bit(p[5]);
      } else if (!bd.get_bit(p[6])) {
        if (!bd.get_bit(p[7])) {
          v = 5 + bd.get_bit(159);
        } else {
          v = 7 + 2 * bd.get_bit(165) + bd.get_bit(145);
        }
      } else {
        int bit1 = bd.get_bit(p[8]);
        int bit0 = bd.get_bit(p[9 + bit1]);
        int cat = 2 * bit1 + bit0 + 2;
        v = 0;
        for (int i = 0; i < kCatLen[cat]; i++)
          v += v + bd.get_bit(kCatProbs[cat][i]);
        v += kCatBase[cat];
      }
    }
    if (bd.get_bit(128)) v = -v;
    out[kZigzag[n]] = v * (n > 0 ? dq_ac : dq_dc);
    if (++n == 16) return 16;
    p = probs_t + (kBands[n] * 3 + nctx) * 11;
  }
  return 16;
}

struct MBInfo {
  uint8_t segment, skip, is4, uvmode;
  uint8_t imodes[16];
};

}  // namespace

// coeff_probs_in: ONE buffer of 2*4*8*3*11 bytes — the default
// coefficient probabilities followed by the update probabilities
// (host/webp.py concatenates _vp8_tables.COEFF_PROBS + COEFF_UPDATE_PROBS).
extern "C" int webp_vp8_decode(const uint8_t* data, int64_t dn,
                               const uint8_t* coeff_probs_in,
                               const uint8_t* kf_bmode_probs /*10*10*9*/,
                               int w, int h, uint8_t* rgb_out) {
  try {
    // ---- headers (port of _parse_headers) ----
    if (dn < 10) return 1;
    uint32_t tag = data[0] | (data[1] << 8) | (uint32_t(data[2]) << 16);
    if (tag & 1) return 1;  // interframe
    int64_t part0_size = tag >> 5;
    if (!(data[3] == 0x9d && data[4] == 0x01 && data[5] == 0x2a)) return 1;
    int sw = (data[6] | (data[7] << 8)) & 0x3FFF;
    int sh = (data[8] | (data[9] << 8)) & 0x3FFF;
    if (sw != w || sh != h || w == 0 || h == 0) return 1;
    if (10 + part0_size > dn) return 1;
    BoolDecoder bd;
    bd.init(data + 10, part0_size);

    bd.get_literal(2);  // color_space, clamping_type

    int seg_enabled = bd.get_bit(128);
    int seg_update_map = 0, seg_abs = 0;
    int seg_q[4] = {0, 0, 0, 0}, seg_lf[4] = {0, 0, 0, 0};
    int tree_probs[3] = {255, 255, 255};
    if (seg_enabled) {
      seg_update_map = bd.get_bit(128);
      if (bd.get_bit(128)) {
        seg_abs = bd.get_bit(128);
        for (int i = 0; i < 4; i++) seg_q[i] = bd.get_flagged_signed(7);
        for (int i = 0; i < 4; i++) seg_lf[i] = bd.get_flagged_signed(6);
      }
      if (seg_update_map)
        for (int i = 0; i < 3; i++)
          tree_probs[i] = bd.get_bit(128) ? bd.get_literal(8) : 255;
    }

    int f_simple = bd.get_bit(128);
    int f_level = bd.get_literal(6);
    int f_sharp = bd.get_literal(3);
    int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
    int use_delta = bd.get_bit(128);
    if (use_delta && bd.get_bit(128)) {
      for (int i = 0; i < 4; i++)
        if (bd.get_bit(128)) ref_delta[i] = bd.get_signed(6);
      for (int i = 0; i < 4; i++)
        if (bd.get_bit(128)) mode_delta[i] = bd.get_signed(6);
    }

    int num_parts = 1 << bd.get_literal(2);
    int64_t part_base = 10 + part0_size;
    int64_t sizes_len = 3 * (num_parts - 1);
    if (part_base + sizes_len > dn) return 1;
    BoolDecoder parts[8];
    int64_t off = part_base + sizes_len;
    for (int i = 0; i < num_parts - 1; i++) {
      int64_t p = part_base + 3 * i;
      int64_t sz = data[p] | (data[p + 1] << 8) | (int64_t(data[p + 2]) << 16);
      if (off + sz > dn) return 1;
      parts[i].init(data + off, sz);
      off += sz;
    }
    parts[num_parts - 1].init(data + off, dn - off);

    int q_base = bd.get_literal(7);
    int q_y1dc = bd.get_flagged_signed(4);
    int q_y2dc = bd.get_flagged_signed(4);
    int q_y2ac = bd.get_flagged_signed(4);
    int q_uvdc = bd.get_flagged_signed(4);
    int q_uvac = bd.get_flagged_signed(4);

    bd.get_bit(128);  // refresh_entropy_probs

    uint8_t probs[4 * 8 * 3 * 11];
    std::memcpy(probs, coeff_probs_in, sizeof(probs));
    const uint8_t* upd = coeff_probs_in + 4 * 8 * 3 * 11;  // update probs
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++) {
            int idx = ((t * 8 + b) * 3 + c) * 11 + p;
            if (bd.get_bit(upd[idx])) probs[idx] = uint8_t(bd.get_literal(8));
          }

    int use_skip = bd.get_bit(128);
    int skip_prob = use_skip ? bd.get_literal(8) : 0;

    int mb_w = (w + 15) >> 4;
    int mb_h = (h + 15) >> 4;
    int64_t W = int64_t(mb_w) * 16, H = int64_t(mb_h) * 16;

    // ---- per-segment quant ----
    int dqm[4][6];
    for (int s = 0; s < 4; s++) {
      int q = seg_enabled ? (seg_abs ? seg_q[s] : q_base + seg_q[s]) : q_base;
      q = q < 0 ? 0 : (q > 127 ? 127 : q);
      auto dcq = [&](int idx, int hi) {
        idx = idx < 0 ? 0 : (idx > hi ? hi : idx);
        return int(kDcQ[idx]);
      };
      auto acq = [&](int idx) {
        idx = idx < 0 ? 0 : (idx > 127 ? 127 : idx);
        return int(kAcQ[idx]);
      };
      int y2ac = (acq(q + q_y2ac) * 101581) >> 16;
      dqm[s][0] = dcq(q + q_y1dc, 127);
      dqm[s][1] = acq(q);
      dqm[s][2] = dcq(q + q_y2dc, 127) * 2;
      dqm[s][3] = y2ac < 8 ? 8 : y2ac;
      dqm[s][4] = dcq(q + q_uvdc, 117);
      dqm[s][5] = acq(q + q_uvac);
    }

    // ---- mode parsing (port of _parse_modes) ----
    std::vector<MBInfo> mbs(size_t(mb_w) * mb_h);
    {
      std::vector<uint8_t> top_m(size_t(mb_w) * 4, M_DC);
      for (int my = 0; my < mb_h; my++) {
        uint8_t left_m[4] = {M_DC, M_DC, M_DC, M_DC};
        for (int mx = 0; mx < mb_w; mx++) {
          MBInfo& mb = mbs[size_t(my) * mb_w + mx];
          int segment = 0;
          if (seg_update_map)
            segment = bd.get_bit(tree_probs[0])
                          ? 2 + bd.get_bit(tree_probs[2])
                          : bd.get_bit(tree_probs[1]);
          int skip = use_skip ? bd.get_bit(skip_prob) : 0;
          uint8_t* top = &top_m[size_t(mx) * 4];
          if (bd.get_bit(145)) {  // 16x16
            int ymode = bd.get_bit(156)
                            ? (bd.get_bit(128) ? M_TM : M_HE)
                            : (bd.get_bit(163) ? M_VE : M_DC);
            for (int i = 0; i < 16; i++) mb.imodes[i] = uint8_t(ymode);
            mb.is4 = 0;
            top[0] = top[1] = top[2] = top[3] = uint8_t(ymode);
            left_m[0] = left_m[1] = left_m[2] = left_m[3] = uint8_t(ymode);
          } else {
            mb.is4 = 1;
            for (int y = 0; y < 4; y++) {
              int m = left_m[y];
              for (int x = 0; x < 4; x++) {
                const uint8_t* prob =
                    kf_bmode_probs + (size_t(top[x]) * 10 + m) * 9;
                int i = kBmodeTree[bd.get_bit(prob[0])];
                while (i > 0) i = kBmodeTree[2 * i + bd.get_bit(prob[i])];
                m = -i;
                top[x] = uint8_t(m);
                mb.imodes[4 * y + x] = uint8_t(m);
              }
              left_m[y] = uint8_t(m);
            }
          }
          int uvmode = bd.get_bit(142)
                           ? (bd.get_bit(114)
                                  ? (bd.get_bit(183) ? M_TM : M_HE)
                                  : M_VE)
                           : M_DC;
          mb.segment = uint8_t(segment);
          mb.skip = uint8_t(skip);
          mb.uvmode = uint8_t(uvmode);
        }
      }
    }

    // ---- planes with borders ----
    int64_t ys = W + 5;                 // Y stride
    int64_t cs = W / 2 + 1;             // chroma stride
    std::vector<uint8_t> Yp(size_t(H + 1) * ys);
    std::vector<uint8_t> Up(size_t(H / 2 + 1) * cs);
    std::vector<uint8_t> Vp(size_t(H / 2 + 1) * cs);
    std::memset(Yp.data(), 127, size_t(ys));
    std::memset(Up.data(), 127, size_t(cs));
    std::memset(Vp.data(), 127, size_t(cs));
    for (int64_t y = 1; y <= H; y++) Yp[size_t(y) * ys] = 129;
    for (int64_t y = 1; y <= H / 2; y++) {
      Up[size_t(y) * cs] = 129;
      Vp[size_t(y) * cs] = 129;
    }

    // ---- residual decode + reconstruction ----
    std::vector<uint8_t> top_y_nz(size_t(mb_w) * 4, 0);
    std::vector<uint8_t> top_u_nz(size_t(mb_w) * 2, 0);
    std::vector<uint8_t> top_v_nz(size_t(mb_w) * 2, 0);
    std::vector<uint8_t> top_dc_nz(size_t(mb_w), 0);
    std::vector<int32_t> f_info(size_t(mb_w) * mb_h * 4, 0);

    int32_t coeffs[24][16];
    for (int my = 0; my < mb_h; my++) {
      BoolDecoder& tbd = parts[my & (num_parts - 1)];
      uint8_t left_y_nz[4] = {0, 0, 0, 0};
      uint8_t left_u_nz[2] = {0, 0};
      uint8_t left_v_nz[2] = {0, 0};
      uint8_t left_dc_nz = 0;
      for (int mx = 0; mx < mb_w; mx++) {
        const MBInfo& mb = mbs[size_t(my) * mb_w + mx];
        const int* q = dqm[mb.segment];
        bool has_coeffs = false;
        bool dc_only = false;
        std::memset(coeffs, 0, sizeof(coeffs));
        if (mb.skip) {
          left_y_nz[0] = left_y_nz[1] = left_y_nz[2] = left_y_nz[3] = 0;
          left_u_nz[0] = left_u_nz[1] = 0;
          left_v_nz[0] = left_v_nz[1] = 0;
          for (int i = 0; i < 4; i++) top_y_nz[size_t(mx) * 4 + i] = 0;
          for (int i = 0; i < 2; i++) {
            top_u_nz[size_t(mx) * 2 + i] = 0;
            top_v_nz[size_t(mx) * 2 + i] = 0;
          }
          if (!mb.is4) left_dc_nz = top_dc_nz[mx] = 0;
        } else {
          int first;
          const uint8_t* pp;
          if (!mb.is4) {
            int ctx = top_dc_nz[mx] + left_dc_nz;
            int32_t dc16[16] = {0};
            int nz = get_coeffs(tbd, probs + 1 * 8 * 3 * 11, ctx, 0, q[2],
                                q[3], dc16);
            top_dc_nz[mx] = left_dc_nz = uint8_t(nz > 0);
            if (nz > 1) {
              int32_t dcs[16];
              iwht4x4(dc16, dcs);
              for (int b = 0; b < 16; b++) coeffs[b][0] = dcs[b];
            } else {
              int32_t v = (dc16[0] + 3) >> 3;
              for (int b = 0; b < 16; b++) coeffs[b][0] = v;
            }
            first = 1;
            pp = probs + 0 * 8 * 3 * 11;
          } else {
            first = 0;
            pp = probs + 3 * 8 * 3 * 11;
          }
          bool nz_any = false;
          for (int by = 0; by < 4; by++) {
            int l = left_y_nz[by];
            for (int bx = 0; bx < 4; bx++) {
              int ctx = l + top_y_nz[size_t(mx) * 4 + bx];
              int nz = get_coeffs(tbd, pp, ctx, first, q[0], q[1],
                                  coeffs[4 * by + bx]);
              l = nz > first;
              top_y_nz[size_t(mx) * 4 + bx] = uint8_t(l);
              nz_any |= nz > first;
            }
            left_y_nz[by] = uint8_t(l);
          }
          for (int ch = 0; ch < 2; ch++) {
            uint8_t* tnz = ch == 0 ? top_u_nz.data() : top_v_nz.data();
            uint8_t* lnz = ch == 0 ? left_u_nz : left_v_nz;
            for (int by = 0; by < 2; by++) {
              int l = lnz[by];
              for (int bx = 0; bx < 2; bx++) {
                int ctx = l + tnz[size_t(mx) * 2 + bx];
                int nz = get_coeffs(tbd, probs + 2 * 8 * 3 * 11, ctx, 0,
                                    q[4], q[5],
                                    coeffs[16 + 4 * ch + 2 * by + bx]);
                l = nz > 0;
                tnz[size_t(mx) * 2 + bx] = uint8_t(l);
                nz_any |= nz > 0;
              }
              lnz[by] = uint8_t(l);
            }
          }
          bool dc_any = false;
          if (!mb.is4)
            for (int b = 0; b < 16; b++) dc_any |= coeffs[b][0] != 0;
          has_coeffs = nz_any || dc_any;
          dc_only = !mb.is4;
        }

        // ---- filter strength ----
        if (f_level || seg_enabled) {
          int base;
          if (seg_enabled) {
            base = seg_lf[mb.segment];
            if (!seg_abs) base += f_level;
          } else {
            base = f_level;
          }
          if (use_delta) {
            base += ref_delta[0];
            if (mb.is4) base += mode_delta[0];
          }
          int level = base < 0 ? 0 : (base > 63 ? 63 : base);
          if (level > 0) {
            int ilevel = level;
            if (f_sharp > 0) {
              ilevel >>= f_sharp > 4 ? 2 : 1;
              if (ilevel > 9 - f_sharp) ilevel = 9 - f_sharp;
            }
            if (ilevel < 1) ilevel = 1;
            int hev_t = level >= 40 ? 2 : (level >= 15 ? 1 : 0);
            int32_t* fi = &f_info[(size_t(my) * mb_w + mx) * 4];
            fi[0] = 2 * level + ilevel;
            fi[1] = ilevel;
            fi[2] = hev_t;
            fi[3] = mb.is4 || has_coeffs;
          }
        }

        // ---- reconstruction ----
        int64_t y0 = 1 + 16 * int64_t(my), x0 = 1 + 16 * int64_t(mx);
        if (!mb.is4) {
          int mode = mb.imodes[0];
          int32_t pred[256];
          pred_block(mode, &Yp[(y0 - 1) * ys + x0], &Yp[y0 * ys + (x0 - 1)],
                     int(ys), Yp[(y0 - 1) * ys + (x0 - 1)], 16, my > 0,
                     mx > 0, pred);
          if (has_coeffs || dc_only) {
            int32_t res[16];
            for (int b = 0; b < 16; b++) {
              bool any = false;
              for (int i = 0; i < 16; i++) any |= coeffs[b][i] != 0;
              if (!any) continue;
              idct4x4(coeffs[b], res);
              int ry = 4 * (b >> 2), rx = 4 * (b & 3);
              for (int yy = 0; yy < 4; yy++)
                for (int xx = 0; xx < 4; xx++)
                  pred[(ry + yy) * 16 + rx + xx] += res[4 * yy + xx];
            }
          }
          for (int yy = 0; yy < 16; yy++)
            for (int xx = 0; xx < 16; xx++)
              Yp[(y0 + yy) * ys + x0 + xx] = clip255(pred[yy * 16 + xx]);
        } else {
          int mb_tr[4];
          if (mx == mb_w - 1 && my > 0) {
            int v = Yp[(y0 - 1) * ys + x0 + 15];
            mb_tr[0] = mb_tr[1] = mb_tr[2] = mb_tr[3] = v;
          } else {
            for (int i = 0; i < 4; i++)
              mb_tr[i] = Yp[(y0 - 1) * ys + x0 + 16 + i];
          }
          for (int b = 0; b < 16; b++) {
            int by = b >> 2, bx = b & 3;
            int64_t ry = y0 + 4 * by, rx = x0 + 4 * bx;
            int t[4], l[4], tr[4];
            for (int i = 0; i < 4; i++) {
              t[i] = Yp[(ry - 1) * ys + rx + i];
              l[i] = Yp[(ry + i) * ys + rx - 1];
            }
            if (bx == 3) {
              for (int i = 0; i < 4; i++) tr[i] = mb_tr[i];
            } else {
              for (int i = 0; i < 4; i++) tr[i] = Yp[(ry - 1) * ys + rx + 4 + i];
            }
            int tl = Yp[(ry - 1) * ys + rx - 1];
            int32_t pred[16];
            pred4(mb.imodes[b], t, tr, l, tl, pred);
            bool any = false;
            for (int i = 0; i < 16; i++) any |= coeffs[b][i] != 0;
            if (any) {
              int32_t res[16];
              idct4x4(coeffs[b], res);
              for (int i = 0; i < 16; i++) pred[i] += res[i];
            }
            for (int yy = 0; yy < 4; yy++)
              for (int xx = 0; xx < 4; xx++)
                Yp[(ry + yy) * ys + rx + xx] = clip255(pred[4 * yy + xx]);
          }
        }

        int64_t cy0 = 1 + 8 * int64_t(my), cx0 = 1 + 8 * int64_t(mx);
        for (int ci = 0; ci < 2; ci++) {
          std::vector<uint8_t>& P = ci == 0 ? Up : Vp;
          int32_t pred[64];
          pred_block(mb.uvmode, &P[(cy0 - 1) * cs + cx0],
                     &P[cy0 * cs + (cx0 - 1)], int(cs),
                     P[(cy0 - 1) * cs + (cx0 - 1)], 8, my > 0, mx > 0,
                     pred);
          for (int b = 0; b < 4; b++) {
            const int32_t* blk = coeffs[16 + 4 * ci + b];
            bool any = false;
            for (int i = 0; i < 16; i++) any |= blk[i] != 0;
            if (!any) continue;
            int32_t res[16];
            idct4x4(blk, res);
            int ry = 4 * (b >> 1), rx = 4 * (b & 1);
            for (int yy = 0; yy < 4; yy++)
              for (int xx = 0; xx < 4; xx++)
                pred[(ry + yy) * 8 + rx + xx] += res[4 * yy + xx];
          }
          for (int yy = 0; yy < 8; yy++)
            for (int xx = 0; xx < 8; xx++)
              P[(cy0 + yy) * cs + cx0 + xx] = clip255(pred[yy * 8 + xx]);
        }
      }
    }

    // ---- loop filter ----
    if (f_level > 0) {
      for (int my = 0; my < mb_h; my++) {
        for (int mx = 0; mx < mb_w; mx++) {
          const int32_t* fi = &f_info[(size_t(my) * mb_w + mx) * 4];
          int limit = fi[0], ilevel = fi[1], hev_t = fi[2], inner = fi[3];
          if (limit == 0) continue;
          int64_t y0 = 1 + 16 * int64_t(my), x0 = 1 + 16 * int64_t(mx);
          if (f_simple) {
            if (mx > 0)
              filter_edge_simple(Yp.data(), ys, y0, x0, 16, limit + 4,
                                 false);
            if (inner)
              for (int dx = 4; dx <= 12; dx += 4)
                filter_edge_simple(Yp.data(), ys, y0, x0 + dx, 16, limit,
                                   false);
            if (my > 0)
              filter_edge_simple(Yp.data(), ys, x0, y0, 16, limit + 4, true);
            if (inner)
              for (int dy = 4; dy <= 12; dy += 4)
                filter_edge_simple(Yp.data(), ys, x0, y0 + dy, 16, limit,
                                   true);
          } else {
            int64_t cy0 = 1 + 8 * int64_t(my), cx0 = 1 + 8 * int64_t(mx);
            if (mx > 0) {
              filter_edge(Yp.data(), ys, y0, x0, 16, limit + 4, ilevel,
                          hev_t, true, false);
              filter_edge(Up.data(), cs, cy0, cx0, 8, limit + 4, ilevel,
                          hev_t, true, false);
              filter_edge(Vp.data(), cs, cy0, cx0, 8, limit + 4, ilevel,
                          hev_t, true, false);
            }
            if (inner) {
              for (int dx = 4; dx <= 12; dx += 4)
                filter_edge(Yp.data(), ys, y0, x0 + dx, 16, limit, ilevel,
                            hev_t, false, false);
              filter_edge(Up.data(), cs, cy0, cx0 + 4, 8, limit, ilevel,
                          hev_t, false, false);
              filter_edge(Vp.data(), cs, cy0, cx0 + 4, 8, limit, ilevel,
                          hev_t, false, false);
            }
            if (my > 0) {
              filter_edge(Yp.data(), ys, x0, y0, 16, limit + 4, ilevel,
                          hev_t, true, true);
              filter_edge(Up.data(), cs, cx0, cy0, 8, limit + 4, ilevel,
                          hev_t, true, true);
              filter_edge(Vp.data(), cs, cx0, cy0, 8, limit + 4, ilevel,
                          hev_t, true, true);
            }
            if (inner) {
              for (int dy = 4; dy <= 12; dy += 4)
                filter_edge(Yp.data(), ys, x0, y0 + dy, 16, limit, ilevel,
                            hev_t, false, true);
              filter_edge(Up.data(), cs, cx0, cy0 + 4, 8, limit, ilevel,
                          hev_t, false, true);
              filter_edge(Vp.data(), cs, cx0, cy0 + 4, 8, limit, ilevel,
                          hev_t, false, true);
            }
          }
        }
      }
    }

    // ---- fancy upsample + YUV->RGB (ports _fancy_upsample) ----
    int uv_w = (w + 1) / 2;
    std::vector<int32_t> u_row(w), v_row(w);
    const uint8_t* Yb = Yp.data() + ys + 1;       // borderless view
    const uint8_t* Ub = Up.data() + cs + 1;
    const uint8_t* Vb = Vp.data() + cs + 1;
    int uv_h = (h + 1) / 2;
    for (int j = 0; j < h; j++) {
      int a, b;
      if (j == 0) {
        a = b = 0;
      } else if (j & 1) {
        a = (j - 1) >> 1;
        b = (j + 1) >> 1;
        if (b > uv_h - 1) b = uv_h - 1;
      } else {
        a = j >> 1;
        b = a - 1;
      }
      blend_row(Ub + int64_t(a) * cs, Ub + int64_t(b) * cs, uv_w, w,
                u_row.data());
      blend_row(Vb + int64_t(a) * cs, Vb + int64_t(b) * cs, uv_w, w,
                v_row.data());
      const uint8_t* yrow = Yb + int64_t(j) * ys;
      uint8_t* out = rgb_out + int64_t(j) * w * 3;
      for (int x = 0; x < w; x++)
        yuv_to_rgb_px(yrow[x], u_row[x], v_row[x], out + 3 * x);
    }
    return 0;
  } catch (...) {
    return 1;
  }
}
