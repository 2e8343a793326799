// GIF LZW of the port's host codec: the decode and encode inner loops
// in C++ behind a plain C interface (loaded with ctypes by host/native.py,
// which builds this file with g++ at first use into
// build/native/<hash>/libgifdec.so; nothing builds at import). The plain
// versions are host/gif.py's _lzw_decode_py and _lzw_encode_py, reached
// with native=False: the same variable-width code stream, the same
// clear/EOI handling, the same KwKwK and truncation semantics.
//
// The same code as the JAX package's native GIF codec, so that the
// port's native lane gives its bits: build with the same flags
// (-O3 -march=native -fPIC -Wall -Wextra -shared). No entry point keeps
// state between calls, so concurrent calls from server threads are safe.

#include <cstdint>
#include <cstring>

namespace {
constexpr int kMaxCodes = 4096;
}

// Decode LZW bytes into out[0..max_pixels). Returns the number of
// pixels produced (truncated input returns what decoded so far) or -1
// on a corrupt stream (bad min code size, first code not a root, code
// beyond the table); host/gif.py raises ValueError on it.
extern "C" int64_t gif_lzw_decode(const uint8_t* data, int64_t n,
                                  int min_code_size, uint8_t* out,
                                  int64_t max_pixels) {
  if (min_code_size < 2 || min_code_size > 11) return -1;
  const int clear = 1 << min_code_size;
  const int eoi = clear + 1;
  int32_t prefix[kMaxCodes];
  uint8_t suffix[kMaxCodes];
  uint8_t scratch[kMaxCodes];
  for (int i = 0; i < clear; i++) {
    prefix[i] = -1;
    suffix[i] = uint8_t(i);
  }
  for (int i = clear; i < kMaxCodes; i++) prefix[i] = -1;
  int next_code = eoi + 1;
  int width = min_code_size + 1;

  int64_t n_out = 0;
  uint32_t acc = 0;
  int nbits = 0;
  int64_t pos = 0;
  int prev = -1;

  // emit the chain for `code`, clipped to max_pixels keeping its head;
  // returns the chain's first byte
  auto emit = [&](int code) -> uint8_t {
    int k = 0;
    int c = code;
    while (c >= 0) {
      scratch[k++] = suffix[c];
      c = prefix[c];
    }
    int64_t take = k;
    if (n_out + take > max_pixels) take = max_pixels - n_out;
    for (int64_t i = 0; i < take; i++) out[n_out + i] = scratch[k - 1 - i];
    n_out += take;
    return scratch[k - 1];
  };

  while (n_out < max_pixels) {
    while (nbits < width) {
      if (pos >= n) return n_out;  // truncated stream
      acc |= uint32_t(data[pos++]) << nbits;
      nbits += 8;
    }
    int code = int(acc & ((1u << width) - 1));
    acc >>= width;
    nbits -= width;
    if (code == clear) {
      next_code = eoi + 1;
      width = min_code_size + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0) {
      if (code >= clear) return -1;  // first code must be a root
      out[n_out++] = uint8_t(code);
      prev = code;
      continue;
    }
    uint8_t first;
    if (code < next_code) {
      first = emit(code);
    } else if (code == next_code) {
      int c = prev;
      while (prefix[c] >= 0) c = prefix[c];
      first = suffix[c];
      if (n_out < max_pixels) {
        emit(prev);
        if (n_out < max_pixels) out[n_out++] = first;
      }
    } else {
      return -1;  // code out of range
    }
    if (next_code < kMaxCodes) {
      prefix[next_code] = prev;
      suffix[next_code] = first;
      next_code++;
      if (next_code == (1 << width) && width < 12) width++;
    }
    prev = code;
  }
  return n_out;
}

// Encode n index bytes. Writes at most out_cap bytes; returns the byte
// count, or -1 if out_cap would overflow (callers size out generously:
// worst case is ~1.5 bits of overhead per input code plus resets, so
// 2*n + 64 always fits). Table: (prev_code, byte) -> code via a flat
// 4096*256 array (1 MiB of int16), memset on clear-code resets.
extern "C" int64_t gif_lzw_encode(const uint8_t* idx, int64_t n,
                                  int min_code_size, uint8_t* out,
                                  int64_t out_cap) {
  if (min_code_size < 2 || min_code_size > 11) return -1;
  const int clear = 1 << min_code_size;
  const int eoi = clear + 1;
  static_assert(kMaxCodes * 256 * sizeof(int16_t) == (1 << 21), "");
  int16_t* table = new int16_t[kMaxCodes * 256];
  std::memset(table, -1, kMaxCodes * 256 * sizeof(int16_t));
  int next_code = eoi + 1;
  int width = min_code_size + 1;

  int64_t n_out = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  auto put = [&](int code) {
    acc |= uint32_t(code) << nbits;
    nbits += width;
    while (nbits >= 8) {
      if (n_out >= out_cap) {
        overflow = true;
        nbits = 0;
        return;
      }
      out[n_out++] = uint8_t(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
  };

  put(clear);
  int prev = -1;
  for (int64_t i = 0; i < n && !overflow; i++) {
    int v = idx[i];
    if (prev < 0) {
      prev = v;
      continue;
    }
    int16_t nxt = table[prev * 256 + v];
    if (nxt >= 0) {
      prev = nxt;
      continue;
    }
    put(prev);
    if (next_code < kMaxCodes) {
      table[prev * 256 + v] = int16_t(next_code);
      if (next_code == (1 << width) && width < 12) width++;
      next_code++;
    } else {
      put(clear);
      std::memset(table, -1, kMaxCodes * 256 * sizeof(int16_t));
      next_code = eoi + 1;
      width = min_code_size + 1;
    }
    prev = v;
  }
  if (prev >= 0) put(prev);
  put(eoi);
  if (nbits && !overflow) {
    if (n_out >= out_cap) {
      overflow = true;
    } else {
      out[n_out++] = uint8_t(acc & 0xFF);
    }
  }
  delete[] table;
  return overflow ? -1 : n_out;
}
