// Native 3dfcoord codec for GROMACS .xtc coordinate blocks.
//
// C++ fast path behind clustering_tpu_torch.utils.xtc (the pure-Python
// implementation is the reference; both are byte-compatible with the
// xdrfile library the reference project vendors,
// src/coords_file/xdrfile/xdrfile.c:743-1254). Exposed as a C ABI and
// loaded via ctypes. Build: `make -C clustering_tpu_torch/native`.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

const int MAGICINTS[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003,
    16384, 20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031,
    131072, 165140, 208063, 262144, 330280, 416127, 524287, 660561,
    832255, 1048576, 1321122, 1664510, 2097152, 2642245, 3329021,
    4194304, 5284491, 6658042, 8388607, 10568983, 13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = sizeof(MAGICINTS) / sizeof(*MAGICINTS);

inline int bits_for(uint32_t size) {
  int n = 0;
  while (size) {
    ++n;
    size >>= 1;
  }
  return n;
}

// bit budget for a mixed-radix packed triple: byte length of the size
// product plus leading-byte bits
int bits_for_triple(const uint32_t sizes[3]) {
  uint64_t prod = (uint64_t)sizes[0] * sizes[1] * sizes[2];
  int n_bytes = 1;
  uint64_t p = prod;
  while (p >= 256) {
    ++n_bytes;
    p >>= 8;
  }
  return (n_bytes - 1) * 8 + bits_for((uint32_t)p);
}

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t nbytes = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool overflow = false;

  void put(uint32_t value, int nbits) {
    if (nbits == 0) return;
    acc = (acc << nbits) | (value & ((nbits >= 32) ? 0xffffffffu
                                                   : ((1u << nbits) - 1)));
    nacc += nbits;
    while (nacc >= 8) {
      nacc -= 8;
      if (nbytes >= cap) {
        overflow = true;
        return;
      }
      out[nbytes++] = (uint8_t)(acc >> nacc);
    }
    acc &= (1ull << nacc) - 1;
  }

  void put_triple(const uint32_t nums[3], const uint32_t sizes[3],
                  int nbits) {
    // combined = ((n0*s1)+n1)*s2+n2, little-endian byte emission
    uint64_t combined =
        ((uint64_t)nums[0] * sizes[1] + nums[1]) * sizes[2] + nums[2];
    uint8_t le[8];
    int n_bytes = 0;
    uint64_t t = combined;
    do {
      le[n_bytes++] = (uint8_t)(t & 0xff);
      t >>= 8;
    } while (t);
    if (nbits >= n_bytes * 8) {
      for (int i = 0; i < n_bytes; ++i) put(le[i], 8);
      put(0, nbits - n_bytes * 8);
    } else {
      for (int i = 0; i < n_bytes - 1; ++i) put(le[i], 8);
      put(le[n_bytes - 1], nbits - (n_bytes - 1) * 8);
    }
  }

  int64_t finish() {
    if (overflow) return -1;
    if (nacc > 0) {
      if (nbytes >= cap) return -1;
      out[nbytes] = (uint8_t)(acc << (8 - nacc));
      return nbytes + 1;
    }
    return nbytes;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;  // bits

  uint32_t get(int nbits) {
    if (nbits == 0) return 0;
    uint32_t v = 0;
    int64_t p = pos;
    pos += nbits;
    while (nbits > 0) {
      int64_t byte = p >> 3;
      int off = p & 7;
      int take = 8 - off;
      if (take > nbits) take = nbits;
      uint8_t b = (byte < len) ? data[byte] : 0;
      uint8_t chunk = (uint8_t)((b >> (8 - off - take)) & ((1 << take) - 1));
      v = (v << take) | chunk;
      p += take;
      nbits -= take;
    }
    return v;
  }

  void get_triple(const uint32_t sizes[3], int nbits, int32_t nums[3]) {
    uint8_t le[8] = {0};
    int n_bytes = 0;
    while (nbits > 8) {
      le[n_bytes++] = (uint8_t)get(8);
      nbits -= 8;
    }
    if (nbits > 0) le[n_bytes++] = (uint8_t)get(nbits);
    uint64_t combined = 0;
    for (int i = n_bytes - 1; i >= 0; --i)
      combined = (combined << 8) | le[i];
    nums[2] = (int32_t)(combined % sizes[2]);
    combined /= sizes[2];
    nums[1] = (int32_t)(combined % sizes[1]);
    nums[0] = (int32_t)(combined / sizes[1]);
  }
};

inline void be32(uint8_t* p, int32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

inline int32_t rd32(const uint8_t* p) {
  return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
}

inline void be32f(uint8_t* p, float v) {
  int32_t iv;
  std::memcpy(&iv, &v, 4);
  be32(p, iv);
}

inline float rdf(const uint8_t* p) {
  int32_t iv = rd32(p);
  float v;
  std::memcpy(&v, &iv, 4);
  return v;
}

}  // namespace

extern "C" {

// Compress the 3dfcoord block (natoms int + precision + bounds + stream,
// XDR padded). Returns bytes written or -1 on error/capacity overflow.
long long xtc3_compress(const float* coords, int natoms, float precision,
                        unsigned char* out, long long out_cap) {
  if (out_cap < 4) return -1;
  uint8_t* op = out;
  be32(op, natoms);
  op += 4;
  if (natoms <= 9) {
    if (out_cap < 4 + 12 * natoms) return -1;
    for (int i = 0; i < natoms * 3; ++i, op += 4) be32f(op, coords[i]);
    return op - out;
  }
  if (precision <= 0) precision = 1000.0f;
  // fixed-point quantization (fp32 arithmetic, trunc toward zero)
  int32_t* ints = new int32_t[(int64_t)natoms * 3];
  int32_t minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  int64_t mindiff = INT64_MAX;
  int32_t old[3] = {0, 0, 0};
  for (int i = 0; i < natoms; ++i) {
    int64_t diff = 0;
    for (int k = 0; k < 3; ++k) {
      float x = coords[i * 3 + k];
      float lf = (x >= 0.0f) ? x * precision + 0.5f : x * precision - 0.5f;
      int32_t v = (int32_t)lf;
      ints[i * 3 + k] = v;
      if (v < minint[k]) minint[k] = v;
      if (v > maxint[k]) maxint[k] = v;
      diff += std::llabs((long long)old[k] - v);
      old[k] = v;
    }
    if (i >= 1 && diff < mindiff) mindiff = diff;
  }
  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int k = 0; k < 3; ++k)
    sizeint[k] = (uint32_t)(maxint[k] - minint[k] + 1);
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int k = 0; k < 3; ++k) bitsizeint[k] = bits_for(sizeint[k]);
    bitsize = 0;
  } else {
    bitsize = bits_for_triple(sizeint);
  }
  int smallidx = FIRSTIDX;
  while (smallidx < LASTIDX && MAGICINTS[smallidx] < mindiff) ++smallidx;

  if (out_cap < 4 + 4 + 24 + 4 + 4) {
    delete[] ints;
    return -1;
  }
  be32f(op, precision);
  op += 4;
  for (int k = 0; k < 3; ++k, op += 4) be32(op, minint[k]);
  for (int k = 0; k < 3; ++k, op += 4) be32(op, maxint[k]);
  be32(op, smallidx);
  op += 4;
  uint8_t* len_slot = op;
  op += 4;

  int maxidx = (smallidx + 8 < LASTIDX) ? smallidx + 8 : LASTIDX;
  int minidx = maxidx - 8;
  int smaller = MAGICINTS[(smallidx - 1 > FIRSTIDX) ? smallidx - 1
                                                    : FIRSTIDX] / 2;
  int smallnum = MAGICINTS[smallidx] / 2;
  uint32_t sizesmall[3] = {(uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx]};
  int larger = MAGICINTS[maxidx] / 2;

  BitWriter bw{op, out_cap - (op - out)};
  int prevrun = -1;
  int32_t prevcoord[3] = {0, 0, 0};
  int i = 0;
  while (i < natoms) {
    bool is_small = false;
    int32_t* this_c = ints + (int64_t)i * 3;
    int is_smaller;
    if (smallidx < maxidx && i >= 1 &&
        std::abs(this_c[0] - prevcoord[0]) < larger &&
        std::abs(this_c[1] - prevcoord[1]) < larger &&
        std::abs(this_c[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    int32_t cur[3] = {this_c[0], this_c[1], this_c[2]};
    if (i + 1 < natoms) {
      int32_t* nxt = this_c + 3;
      if (std::abs(cur[0] - nxt[0]) < smallnum &&
          std::abs(cur[1] - nxt[1]) < smallnum &&
          std::abs(cur[2] - nxt[2]) < smallnum) {
        // swap with the next atom (water-molecule optimization)
        for (int k = 0; k < 3; ++k) {
          int32_t t = cur[k];
          cur[k] = nxt[k];
          nxt[k] = t;
        }
        is_small = true;
      }
    }
    uint32_t first[3];
    for (int k = 0; k < 3; ++k)
      first[k] = (uint32_t)(cur[k] - minint[k]);
    if (bitsize == 0) {
      for (int k = 0; k < 3; ++k) bw.put(first[k], bitsizeint[k]);
    } else {
      bw.put_triple(first, sizeint, bitsize);
    }
    for (int k = 0; k < 3; ++k) prevcoord[k] = cur[k];
    ++i;

    uint32_t run_vals[24];
    int run = 0;
    if (!is_small && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      int32_t* rc = ints + (int64_t)i * 3;
      if (is_smaller == -1) {
        int64_t s = 0;
        for (int k = 0; k < 3; ++k) {
          int64_t d = rc[k] - prevcoord[k];
          s += d * d;
        }
        if (s >= (int64_t)smaller * smaller) is_smaller = 0;
      }
      for (int k = 0; k < 3; ++k)
        run_vals[run++] = (uint32_t)(rc[k] - prevcoord[k] + smallnum);
      for (int k = 0; k < 3; ++k) prevcoord[k] = rc[k];
      ++i;
      is_small =
          i < natoms &&
          std::abs(ints[(int64_t)i * 3] - prevcoord[0]) < smallnum &&
          std::abs(ints[(int64_t)i * 3 + 1] - prevcoord[1]) < smallnum &&
          std::abs(ints[(int64_t)i * 3 + 2] - prevcoord[2]) < smallnum;
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      bw.put(1, 1);
      bw.put((uint32_t)(run + is_smaller + 1), 5);
    } else {
      bw.put(0, 1);
    }
    for (int k = 0; k < run; k += 3)
      bw.put_triple(&run_vals[k], sizesmall, smallidx);
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = MAGICINTS[smallidx - 1] / 2;
      } else {
        smaller = smallnum;
        smallnum = MAGICINTS[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] =
          (uint32_t)MAGICINTS[smallidx];
    }
  }
  delete[] ints;
  int64_t payload = bw.finish();
  if (payload < 0) return -1;
  be32(len_slot, (int32_t)payload);
  op += payload;
  int pad = (4 - (int)(payload % 4)) % 4;
  if (op - out + pad > out_cap) return -1;
  for (int k = 0; k < pad; ++k) *op++ = 0;
  return op - out;
}

// Decompress a 3dfcoord block. Returns bytes consumed or -1.
long long xtc3_decompress(const unsigned char* data, long long data_len,
                          float* out_coords, int* natoms_out,
                          float* precision_out) {
  if (data_len < 4) return -1;
  const uint8_t* p = data;
  int natoms = rd32(p);
  p += 4;
  if (natoms < 0) return -1;
  *natoms_out = natoms;
  if (natoms <= 9) {
    if (data_len < 4 + 12 * natoms) return -1;
    for (int i = 0; i < natoms * 3; ++i, p += 4) out_coords[i] = rdf(p);
    *precision_out = 0.0f;
    return p - data;
  }
  if (data_len < 4 + 4 + 24 + 4 + 4) return -1;
  float precision = rdf(p);
  p += 4;
  *precision_out = precision;
  int32_t minint[3], maxint[3];
  for (int k = 0; k < 3; ++k, p += 4) minint[k] = rd32(p);
  for (int k = 0; k < 3; ++k, p += 4) maxint[k] = rd32(p);
  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  for (int k = 0; k < 3; ++k)
    sizeint[k] = (uint32_t)(maxint[k] - minint[k] + 1);
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    for (int k = 0; k < 3; ++k) bitsizeint[k] = bits_for(sizeint[k]);
    bitsize = 0;
  } else {
    bitsize = bits_for_triple(sizeint);
  }
  // reject streams whose header/stream fields would index MAGICINTS out of
  // bounds, divide by zero in the mixed-radix unpack, or write past the
  // natoms*3 output buffer (the pure-Python codec raises; corrupt input
  // must never corrupt memory here)
  if (bitsize != 0 &&
      (sizeint[0] == 0 || sizeint[1] == 0 || sizeint[2] == 0))
    return -1;
  int smallidx = rd32(p);
  p += 4;
  if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return -1;
  int smaller = MAGICINTS[(smallidx - 1 > FIRSTIDX) ? smallidx - 1
                                                    : FIRSTIDX] / 2;
  int smallnum = MAGICINTS[smallidx] / 2;
  uint32_t sizesmall[3] = {(uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx],
                           (uint32_t)MAGICINTS[smallidx]};
  int32_t nbytes = rd32(p);
  p += 4;
  if (nbytes < 0 || p - data + nbytes > data_len) return -1;
  BitReader br{p, nbytes};
  p += nbytes + ((4 - nbytes % 4) % 4);

  float inv_precision = 1.0f / precision;
  int i = 0;
  int run = 0;
  while (i < natoms) {
    int32_t a[3];
    if (bitsize == 0) {
      for (int k = 0; k < 3; ++k) a[k] = (int32_t)br.get(bitsizeint[k]);
    } else {
      br.get_triple(sizeint, bitsize, a);
    }
    for (int k = 0; k < 3; ++k) a[k] += minint[k];
    int32_t prevcoord[3] = {a[0], a[1], a[2]};
    int flag = (int)br.get(1);
    int is_smaller = 0;
    if (flag == 1) {
      run = (int)br.get(5);
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller -= 1;
    }
    if (run > 0) {
      for (int k = 0; k < run; k += 3) {
        // each triple writes one atom (two for the swapped first pair) --
        // bound against natoms before writing
        if (i + ((k == 0) ? 2 : 1) > natoms) return -1;
        int32_t v[3];
        br.get_triple(sizesmall, smallidx, v);
        int32_t x[3];
        for (int m = 0; m < 3; ++m)
          x[m] = v[m] + prevcoord[m] - smallnum;
        if (k == 0) {
          // the encoder swapped this pair: delta-target first
          for (int m = 0; m < 3; ++m)
            out_coords[(int64_t)i * 3 + m] = x[m] * inv_precision;
          for (int m = 0; m < 3; ++m)
            out_coords[(int64_t)(i + 1) * 3 + m] = a[m] * inv_precision;
          i += 2;
        } else {
          for (int m = 0; m < 3; ++m)
            out_coords[(int64_t)i * 3 + m] = x[m] * inv_precision;
          i += 1;
        }
        for (int m = 0; m < 3; ++m) prevcoord[m] = x[m];
      }
    } else {
      for (int m = 0; m < 3; ++m)
        out_coords[(int64_t)i * 3 + m] = a[m] * inv_precision;
      i += 1;
    }
    smallidx += is_smaller;
    if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return -1;
    if (is_smaller < 0) {
      smallnum = smaller;
      smaller = (smallidx > FIRSTIDX) ? MAGICINTS[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = MAGICINTS[smallidx] / 2;
    }
    sizesmall[0] = sizesmall[1] = sizesmall[2] =
        (uint32_t)MAGICINTS[smallidx];
  }
  return p - data;
}

}  // extern "C"
