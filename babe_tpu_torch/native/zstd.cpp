// Host code for reading orbax checkpoint directories: a Zstandard decoder
// (RFC 8878, every frame and block form except dictionaries), CRC-32C
// (Castagnoli, the checksum of OCDBT manifests and B-tree nodes) and
// XXH64 (the checksum of a zstd frame's content).
//
// Built with g++ at first use by babe_tpu_torch/native/__init__.py and
// bound with ctypes.  Every entry point is reentrant: a call's decoder
// state lives on its stack, and the last error's text is per thread.
// A malformed, truncated or dictionary frame, or a checksum that does not
// match, makes the call fail with a message; it never returns bytes that
// the frame does not encode.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Corrupt(what); }

thread_local std::string g_error;

// how often each form of the format was met, over all calls: the tests
// read these to show that their inputs reach every path of the decoder
enum Feature {
  F_FRAME, F_SKIPPABLE, F_CHECKSUM, F_NO_FCS, F_SINGLE_SEGMENT,
  F_BLOCK_RAW, F_BLOCK_RLE, F_BLOCK_COMPRESSED,
  F_LIT_RAW, F_LIT_RLE, F_LIT_COMPRESSED, F_LIT_TREELESS,
  F_LIT_1STREAM, F_LIT_4STREAMS, F_HUF_DIRECT, F_HUF_FSE,
  F_SEQ_NONE, F_SEQ_PREDEFINED, F_SEQ_RLE, F_SEQ_FSE, F_SEQ_REPEAT,
  F_REPEAT_OFFSET, F_REPEAT_OFFSET_LL0, F_LONG_NSEQ,
  F_COUNT
};
std::atomic<uint64_t> g_features[F_COUNT];

inline void seen(Feature f) {
  g_features[f].fetch_add(1, std::memory_order_relaxed);
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t rd24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------ checksums

uint32_t g_crc_table[8][256];

struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      g_crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int t = 1; t < 8; t++)
        g_crc_table[t][i] = (g_crc_table[t - 1][i] >> 8) ^
                            g_crc_table[0][g_crc_table[t - 1][i] & 0xFF];
  }
} g_crc_init;

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t c,
                                                     const uint8_t* p,
                                                     size_t n) {
  uint64_t c64 = c;
  while (n >= 8) {
    c64 = __builtin_ia32_crc32di(c64, rd64(p));
    p += 8;
    n -= 8;
  }
  c = uint32_t(c64);
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return c;
}
#endif

uint32_t crc32c_sw(uint32_t c, const uint8_t* p, size_t n) {
  while (n >= 8) {  // slicing by 8
    uint64_t v = rd64(p) ^ c;
    c = g_crc_table[7][v & 0xFF] ^ g_crc_table[6][(v >> 8) & 0xFF] ^
        g_crc_table[5][(v >> 16) & 0xFF] ^ g_crc_table[4][(v >> 24) & 0xFF] ^
        g_crc_table[3][(v >> 32) & 0xFF] ^ g_crc_table[2][(v >> 40) & 0xFF] ^
        g_crc_table[1][(v >> 48) & 0xFF] ^ g_crc_table[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = g_crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c;
}

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  uint32_t c = ~crc;
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2")) return ~crc32c_hw(c, p, n);
#endif
  return ~crc32c_sw(c, p, n);
}

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (uint64_t(*p++) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bitstreams

// a forward bitstream (FSE table descriptions): bits taken from the least
// significant end of each byte, first byte first
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int k) const {  // k <= 24; bits past the end read as 0
    uint64_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 5 && byte + i < n; i++)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t(v >> (bit & 7)) & ((1u << k) - 1);
  }
  void skip(int k) { bit += k; }
};

// a backward bitstream (Huffman streams, FSE-coded weights, sequences): the
// stream is one little-endian number whose highest set bit marks its end;
// bits are read from just below that mark down to bit 0
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits left; negative once more were read than exist

  void init(const uint8_t* src, size_t size) {
    if (size == 0) fail("empty bitstream");
    uint8_t last = src[size - 1];
    if (last == 0) fail("bitstream without its end mark");
    p = src;
    n = size;
    pos = int64_t(size - 1) * 8 + highbit(last);
  }
  uint64_t load(size_t byte) const {  // 8 bytes at byte, zeros past the end
    if (byte + 8 <= n) return rd64(p + byte);
    uint64_t v = 0;
    for (size_t i = 0; i < 8 && byte + i < n; i++)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }
  // the next k bits (k <= 56), most significant first; bits below the
  // start of the stream read as 0
  uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = pos - k;
    if (lo >= 0) return (load(size_t(lo) >> 3) >> (lo & 7)) & ((1ULL << k) - 1);
    if (pos <= 0) return 0;
    return (load(0) & ((1ULL << pos) - 1)) << (-lo);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ------------------------------------------------------------ FSE

constexpr int MAX_FSE_LOG = 9;

struct FseCell {
  uint16_t sym;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  FseCell cell[1 << MAX_FSE_LOG];
};

// an FSE table description (RFC 8878 4.1.1); returns the bytes it took
size_t read_ncount(const uint8_t* src, size_t n, int max_sym, int max_log,
                   int16_t* norm, int* nsym, int* log_out) {
  if (n == 0) fail("FSE table description missing");
  FwdBits br{src, n};
  int log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) fail("FSE accuracy log too large");
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (s > max_sym) fail("FSE table description: too many symbols");
    if (prev0) {
      int reps = 0;
      for (;;) {
        int r = int(br.peek(2));
        br.skip(2);
        reps += r;
        if (r != 3) break;
      }
      if (s + reps > max_sym + 1) fail("FSE table description: zeros past the last symbol");
      while (reps--) norm[s++] = 0;
      if (s > max_sym) fail("FSE table description: too many symbols");
    }
    int mx = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nb - 1);
    if (int(low) < mx) {
      count = int(low);
      br.skip(nb - 1);
    } else {
      count = int(br.peek(nb));
      if (count >= threshold) count -= mx;
      br.skip(nb);
    }
    count--;  // -1: a probability below one cell
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < 1) fail("FSE table description: probabilities overflow");
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table description: probabilities do not sum");
  size_t used = (br.bit + 7) >> 3;
  if (used > n) fail("FSE table description truncated");
  *nsym = s;
  *log_out = log;
  return used;
}

void build_fse(const int16_t* norm, int nsym, int log, FseTable& t) {
  int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.cell[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t.cell[pos].sym = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table spread did not close");
  for (int u = 0; u < size; u++) {
    uint16_t s = t.cell[u].sym;
    uint32_t x = next[s]++;
    int bits = log - highbit(x);
    t.cell[u].bits = uint8_t(bits);
    t.cell[u].base = uint16_t((x << bits) - size);
  }
  t.log = log;
}

// ------------------------------------------------------------ Huffman

constexpr int MAX_HUF_BITS = 11;

struct HufTable {
  int bits = 0;
  uint16_t cell[1 << MAX_HUF_BITS];  // symbol | code length << 8
};

// the weights of a Huffman tree, FSE-coded with two interleaved states
int fse_weights(const uint8_t* src, size_t n, uint8_t* w) {
  int16_t norm[256];
  int nsym, log;
  size_t used = read_ncount(src, n, 12, 6, norm, &nsym, &log);
  static thread_local FseTable t;
  build_fse(norm, nsym, log, t);
  BackBits br;
  br.init(src + used, n - used);
  uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
  int out = 0;
  // mirrors the reference decoder's tail: a state update that reads past
  // the start of the stream ends the weights with the other state's symbol
  for (;;) {
    if (out > 253) fail("Huffman weights: too many");
    w[out++] = uint8_t(t.cell[s1].sym);
    s1 = t.cell[s1].base + uint32_t(br.read(t.cell[s1].bits));
    if (br.pos < 0) {
      w[out++] = uint8_t(t.cell[s2].sym);
      break;
    }
    if (out > 253) fail("Huffman weights: too many");
    w[out++] = uint8_t(t.cell[s2].sym);
    s2 = t.cell[s2].base + uint32_t(br.read(t.cell[s2].bits));
    if (br.pos < 0) {
      w[out++] = uint8_t(t.cell[s1].sym);
      break;
    }
  }
  return out;
}

size_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
  if (n == 0) fail("Huffman tree description missing");
  uint8_t w[256];
  int nw;
  size_t used;
  uint8_t hb = src[0];
  if (hb >= 128) {
    seen(F_HUF_DIRECT);
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail("Huffman tree description truncated");
    for (int i = 0; i < nw; i++)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {
    seen(F_HUF_FSE);
    used = 1 + size_t(hb);
    if (hb == 0 || used > n) fail("Huffman tree description truncated");
    nw = fse_weights(src + 1, hb, w);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > MAX_HUF_BITS) fail("Huffman weight too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman tree without weights");
  int bits = highbit(total) + 1;
  if (bits > MAX_HUF_BITS) fail("Huffman code too long");
  uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not close the tree");
  w[nw++] = uint8_t(highbit(rest) + 1);
  uint32_t pos = 0;
  for (int wt = 1; wt <= bits; wt++) {
    for (int s = 0; s < nw; s++) {
      if (w[s] != wt) continue;
      uint32_t span = 1u << (wt - 1);
      std::fill(h.cell + pos, h.cell + pos + span,
                uint16_t(s | ((bits + 1 - wt) << 8)));
      pos += span;
    }
  }
  if (pos != (1u << bits)) fail("Huffman table does not fill");
  h.bits = bits;
  return used;
}

// decode k (1 or 4) Huffman streams, interleaved: while every stream has
// eight bytes left, one 8-byte load gives each stream 56 / bits symbols;
// the ends go symbol by symbol.  Each stream must end where its symbols do.
void huffman_streams(int k, const uint8_t* const* src, const size_t* n,
                     const HufTable& h, uint8_t* const* out,
                     const size_t* count) {
  BackBits br[4];
  size_t done[4] = {0, 0, 0, 0};
  for (int i = 0; i < k; i++) br[i].init(src[i], n[i]);
  const int bits = h.bits;
  const size_t per = size_t(56 / bits);
  const uint16_t* t = h.cell;
  for (;;) {
    bool room = true;
    for (int i = 0; i < k; i++)
      room &= br[i].pos >= 64 && count[i] - done[i] >= per;
    if (!room) break;
    for (int i = 0; i < k; i++) {
      int64_t pos = br[i].pos;
      int64_t b = ((pos + 7) >> 3) - 8;
      uint64_t c = rd64(br[i].p + b) << (64 - (pos - 8 * b));
      uint8_t* o = out[i] + done[i];
      for (size_t j = 0; j < per; j++) {
        uint16_t e = t[c >> (64 - bits)];
        o[j] = uint8_t(e);
        c <<= (e >> 8);
        pos -= (e >> 8);
      }
      br[i].pos = pos;
      done[i] += per;
    }
  }
  for (int i = 0; i < k; i++) {
    for (size_t j = done[i]; j < count[i]; j++) {
      uint16_t e = t[br[i].peek(bits)];
      out[i][j] = uint8_t(e);
      br[i].pos -= e >> 8;
    }
    if (br[i].pos != 0)
      fail("Huffman stream does not end where its symbols do");
  }
}

// ------------------------------------------------------------ sequences

constexpr uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
    16384, 32768, 65536};
constexpr uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
constexpr uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t BLOCK_MAX = 128 * 1024;

// where a frame's bytes go: the caller's buffer of fixed size, or one that
// grows (malloc'd, handed to the caller)
struct Out {
  uint8_t* buf;
  size_t len, cap;
  bool grows;
  void reserve(size_t k) {
    if (k <= cap - len) return;
    if (!grows) fail("the frames decode to more bytes than expected");
    size_t nc = std::max(cap * 2, len + k);
    uint8_t* nb = static_cast<uint8_t*>(std::realloc(buf, nc ? nc : 1));
    if (!nb) throw std::bad_alloc();
    buf = nb;
    cap = nc;
  }
};

struct FrameState {
  uint64_t rep[3] = {1, 4, 8};
  bool has_huf = false, has_ll = false, has_of = false, has_ml = false;
  HufTable huf;
  FseTable ll, of, ml;
  uint8_t lit[BLOCK_MAX];
};

struct Defaults {
  FseTable ll, of, ml;
  Defaults() {
    build_fse(LL_DEFAULT, 36, 6, ll);
    build_fse(OF_DEFAULT, 29, 5, of);
    build_fse(ML_DEFAULT, 53, 6, ml);
  }
};
const Defaults& defaults() {
  static const Defaults d;
  return d;
}

size_t seq_table(int mode, const uint8_t* src, size_t n, FseTable& t,
                 bool& has, const FseTable& def, int max_sym, int max_log) {
  switch (mode) {
    case 0:
      seen(F_SEQ_PREDEFINED);
      t = def;
      has = true;
      return 0;
    case 1:
      seen(F_SEQ_RLE);
      if (n < 1) fail("RLE sequence table truncated");
      if (src[0] > max_sym) fail("RLE sequence symbol out of range");
      t.log = 0;
      t.cell[0] = FseCell{src[0], 0, 0};
      has = true;
      return 1;
    case 2: {
      seen(F_SEQ_FSE);
      int16_t norm[256];
      int nsym, log;
      size_t used = read_ncount(src, n, max_sym, max_log, norm, &nsym, &log);
      build_fse(norm, nsym, log, t);
      has = true;
      return used;
    }
    default:
      seen(F_SEQ_REPEAT);
      if (!has) fail("repeated sequence table with none before it");
      return 0;
  }
}

size_t literals(const uint8_t* src, size_t n, FrameState& st,
                const uint8_t** lit, size_t* nlit) {
  if (n < 1) fail("literals section missing");
  int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type < 2) {
    size_t hsz, rs;
    if (sf == 1) {
      hsz = 2;
      if (n < 2) fail("literals header truncated");
      rs = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else if (sf == 3) {
      hsz = 3;
      if (n < 3) fail("literals header truncated");
      rs = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    } else {
      hsz = 1;
      rs = src[0] >> 3;
    }
    if (rs > BLOCK_MAX) fail("literals larger than a block");
    if (type == 0) {
      seen(F_LIT_RAW);
      if (n - hsz < rs) fail("raw literals truncated");
      *lit = src + hsz;
      *nlit = rs;
      return hsz + rs;
    }
    seen(F_LIT_RLE);
    if (n < hsz + 1) fail("RLE literals truncated");
    std::memset(st.lit, src[hsz], rs);
    *lit = st.lit;
    *nlit = rs;
    return hsz + 1;
  }
  size_t hsz, rs, cs;
  int streams = sf == 0 ? 1 : 4;
  if (sf < 2) {
    hsz = 3;
    if (n < 3) fail("literals header truncated");
    uint32_t h = rd24(src);
    rs = (h >> 4) & 0x3FF;
    cs = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    hsz = 4;
    if (n < 4) fail("literals header truncated");
    uint32_t h = rd32(src);
    rs = (h >> 4) & 0x3FFF;
    cs = (h >> 18) & 0x3FFF;
  } else {
    hsz = 5;
    if (n < 5) fail("literals header truncated");
    uint64_t h = rd32(src) | (uint64_t(src[4]) << 32);
    rs = (h >> 4) & 0x3FFFF;
    cs = (h >> 22) & 0x3FFFF;
  }
  if (rs > BLOCK_MAX) fail("literals larger than a block");
  if (n - hsz < cs) fail("compressed literals truncated");
  const uint8_t* p = src + hsz;
  size_t rem = cs;
  if (type == 2) {
    seen(F_LIT_COMPRESSED);
    size_t used = read_huffman(p, rem, st.huf);
    st.has_huf = true;
    p += used;
    rem -= used;
  } else {
    seen(F_LIT_TREELESS);
    if (!st.has_huf) fail("treeless literals with no Huffman table before");
  }
  if (streams == 1) {
    seen(F_LIT_1STREAM);
    uint8_t* o = st.lit;
    huffman_streams(1, &p, &rem, st.huf, &o, &rs);
  } else {
    seen(F_LIT_4STREAMS);
    if (rem < 6) fail("Huffman jump table truncated");
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    if (6 + s1 + s2 + s3 > rem) fail("Huffman jump table out of range");
    size_t s4 = rem - 6 - s1 - s2 - s3;
    size_t seg = (rs + 3) / 4;
    if (3 * seg > rs) fail("too few literals for four streams");
    const uint8_t* q = p + 6;
    const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
    size_t sizes[4] = {s1, s2, s3, s4};
    uint8_t* outs[4] = {st.lit, st.lit + seg, st.lit + 2 * seg,
                        st.lit + 3 * seg};
    size_t counts[4] = {seg, seg, seg, rs - 3 * seg};
    huffman_streams(4, srcs, sizes, st.huf, outs, counts);
  }
  *lit = st.lit;
  *nlit = rs;
  return hsz + cs;
}

void compressed_block(const uint8_t* src, size_t n, FrameState& st, Out& out,
                      size_t frame_start, uint64_t window) {
  const uint8_t* lit;
  size_t nlit;
  size_t p = literals(src, n, st, &lit, &nlit);
  size_t block_start = out.len;
  if (p >= n) fail("sequences section missing");
  size_t nseq = src[p++];
  if (nseq == 0) {
    seen(F_SEQ_NONE);
    if (p != n) fail("bytes after an empty sequences section");
    out.reserve(nlit);
    std::memcpy(out.buf + out.len, lit, nlit);
    out.len += nlit;
    return;
  }
  if (nseq == 255) {
    seen(F_LONG_NSEQ);
    if (n - p < 2) fail("sequence count truncated");
    nseq = rd16(src + p) + 0x7F00;
    p += 2;
  } else if (nseq >= 128) {
    if (n - p < 1) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + src[p++];
  }
  if (p >= n) fail("sequence modes missing");
  uint8_t modes = src[p++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  const Defaults& d = defaults();
  p += seq_table(modes >> 6, src + p, n - p, st.ll, st.has_ll, d.ll, 35, 9);
  p += seq_table((modes >> 4) & 3, src + p, n - p, st.of, st.has_of, d.of,
                 31, 8);
  p += seq_table((modes >> 2) & 3, src + p, n - p, st.ml, st.has_ml, d.ml,
                 52, 9);
  if (p >= n) fail("sequence bitstream missing");
  BackBits br;
  br.init(src + p, n - p);
  uint32_t sll = uint32_t(br.read(st.ll.log));
  uint32_t sof = uint32_t(br.read(st.of.log));
  uint32_t sml = uint32_t(br.read(st.ml.log));
  size_t litpos = 0;
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < nseq; i++) {
    const FseCell& cll = st.ll.cell[sll];
    const FseCell& cof = st.of.cell[sof];
    const FseCell& cml = st.ml.cell[sml];
    int ofc = cof.sym;
    uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
    uint64_t ml = ML_BASE[cml.sym] + br.read(ML_BITS[cml.sym]);
    uint64_t ll = LL_BASE[cll.sym] + br.read(LL_BITS[cll.sym]);
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    } else {
      seen(ll == 0 ? F_REPEAT_OFFSET_LL0 : F_REPEAT_OFFSET);
      int idx = int(ofv) - 1 + (ll == 0);
      if (idx == 0) {
        off = rep[0];
      } else {
        off = idx == 3 ? rep[0] - 1 : rep[idx];
        if (off == 0) fail("repeat offset of zero");
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = cll.base + uint32_t(br.read(cll.bits));
      sml = cml.base + uint32_t(br.read(cml.bits));
      sof = cof.base + uint32_t(br.read(cof.bits));
    }
    if (ll > nlit - litpos) fail("sequence takes more literals than decoded");
    if (out.len - block_start + ll + ml > BLOCK_MAX)
      fail("block decodes to more than 128 KiB");
    out.reserve(ll + ml);
    std::memcpy(out.buf + out.len, lit + litpos, ll);
    out.len += ll;
    litpos += ll;
    uint64_t have = out.len - frame_start;
    if (off > have || off > window) fail("match offset beyond the window");
    uint8_t* dst = out.buf + out.len;
    const uint8_t* from = dst - off;
    if (off >= ml) {
      std::memcpy(dst, from, ml);
    } else {
      for (uint64_t j = 0; j < ml; j++) dst[j] = from[j];
    }
    out.len += ml;
  }
  if (br.pos != 0) fail("sequence bitstream does not end with its sequences");
  size_t tail = nlit - litpos;
  if (out.len - block_start + tail > BLOCK_MAX)
    fail("block decodes to more than 128 KiB");
  out.reserve(tail);
  std::memcpy(out.buf + out.len, lit + litpos, tail);
  out.len += tail;
}

struct Header {
  size_t size;            // bytes of the frame header
  bool has_fcs, checksum, single;
  uint64_t fcs, window;
};

Header frame_header(const uint8_t* src, size_t n) {
  if (n < 6) fail("zstd frame header truncated");
  uint8_t fhd = src[4];
  Header h{};
  int fcs_flag = fhd >> 6;
  h.single = (fhd >> 5) & 1;
  if (fhd & 8) fail("reserved bit set in the frame header");
  h.checksum = (fhd >> 2) & 1;
  static constexpr int DID_SIZE[4] = {0, 1, 2, 4};
  static constexpr int FCS_SIZE[4] = {0, 2, 4, 8};
  int did_size = DID_SIZE[fhd & 3];
  int fcs_size = fcs_flag == 0 ? (h.single ? 1 : 0) : FCS_SIZE[fcs_flag];
  size_t p = 5;
  if (!h.single) {
    uint8_t wd = src[p++];
    int wlog = 10 + (wd >> 3);
    uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * (wd & 7);
  }
  if (n < p + did_size + fcs_size) fail("zstd frame header truncated");
  uint64_t did = 0;
  for (int i = 0; i < did_size; i++) did |= uint64_t(src[p + i]) << (8 * i);
  p += did_size;
  if (did != 0) fail("zstd frame needs a dictionary (ID " + std::to_string(did) + "), which this decoder does not take");
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; i++) fcs |= uint64_t(src[p + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  p += fcs_size;
  h.has_fcs = fcs_size > 0;
  h.fcs = fcs;
  if (h.single) h.window = fcs;
  h.size = p;
  return h;
}

size_t frame(const uint8_t* src, size_t n, Out& out) {
  seen(F_FRAME);
  Header h = frame_header(src, n);
  if (!h.has_fcs) seen(F_NO_FCS);
  if (h.single) seen(F_SINGLE_SEGMENT);
  size_t p = h.size;
  size_t start = out.len;
  if (h.has_fcs && out.grows) out.reserve(h.fcs);
  auto st = std::make_unique<FrameState>();  // ~140 KiB: off the stack
  for (;;) {
    if (n - p < 3) fail("zstd block header truncated");
    uint32_t bh = rd24(src + p);
    p += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (bsize > BLOCK_MAX) fail("zstd block larger than 128 KiB");
    if (type == 0) {
      seen(F_BLOCK_RAW);
      if (n - p < bsize) fail("raw block truncated");
      out.reserve(bsize);
      std::memcpy(out.buf + out.len, src + p, bsize);
      out.len += bsize;
      p += bsize;
    } else if (type == 1) {
      seen(F_BLOCK_RLE);
      if (n - p < 1) fail("RLE block truncated");
      out.reserve(bsize);
      std::memset(out.buf + out.len, src[p], bsize);
      out.len += bsize;
      p += 1;
    } else if (type == 2) {
      seen(F_BLOCK_COMPRESSED);
      if (n - p < bsize) fail("compressed block truncated");
      compressed_block(src + p, bsize, *st, out, start, h.window);
      p += bsize;
    } else {
      fail("reserved block type");
    }
    if (h.has_fcs && out.len - start > h.fcs)
      fail("frame decodes to more than its content size");
    if (last) break;
  }
  if (h.has_fcs && out.len - start != h.fcs)
    fail("frame decodes to another size than its content size");
  if (h.checksum) {
    seen(F_CHECKSUM);
    if (n - p < 4) fail("content checksum truncated");
    uint32_t want = rd32(src + p);
    uint32_t got = uint32_t(xxh64(out.buf + start, out.len - start, 0));
    if (want != got) fail("content checksum mismatch");
    p += 4;
  }
  return p;
}

constexpr uint32_t ZSTD_MAGIC = 0xFD2FB528u;

inline bool skippable(uint32_t magic) {
  return (magic & 0xFFFFFFF0u) == 0x184D2A50u;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail("no zstd frame");
  size_t p = 0;
  while (p < n) {
    if (n - p < 4) fail("zstd frame truncated");
    uint32_t magic = rd32(src + p);
    if (skippable(magic)) {
      seen(F_SKIPPABLE);
      if (n - p < 8) fail("skippable frame truncated");
      uint64_t sz = rd32(src + p + 4);
      if (n - p - 8 < sz) fail("skippable frame truncated");
      p += 8 + sz;
    } else if (magic == ZSTD_MAGIC) {
      p += frame(src + p, n - p, out);
    } else {
      fail("not a zstd frame (bad magic number)");
    }
  }
}

// the content sizes the frames declare, walking their blocks; -1 when a
// frame does not declare its size
int64_t content_size(const uint8_t* src, size_t n) {
  if (n == 0) fail("no zstd frame");
  size_t p = 0;
  uint64_t total = 0;
  bool known = true;
  while (p < n) {
    if (n - p < 4) fail("zstd frame truncated");
    uint32_t magic = rd32(src + p);
    if (skippable(magic)) {
      if (n - p < 8) fail("skippable frame truncated");
      uint64_t sz = rd32(src + p + 4);
      if (n - p - 8 < sz) fail("skippable frame truncated");
      p += 8 + sz;
      continue;
    }
    if (magic != ZSTD_MAGIC) fail("not a zstd frame (bad magic number)");
    Header h = frame_header(src + p, n - p);
    size_t q = p + h.size;
    for (;;) {
      if (n - q < 3) fail("zstd block header truncated");
      uint32_t bh = rd24(src + q);
      q += 3;
      int type = (bh >> 1) & 3;
      size_t body = type == 1 ? 1 : (bh >> 3);
      if (type == 3) fail("reserved block type");
      if (n - q < body) fail("zstd block truncated");
      q += body;
      if (bh & 1) break;
    }
    if (h.checksum) {
      if (n - q < 4) fail("content checksum truncated");
      q += 4;
    }
    if (h.has_fcs)
      total += h.fcs;
    else
      known = false;
    p = q;
  }
  return known ? int64_t(total) : -1;
}

template <typename F>
int64_t guarded(F&& f) {
  try {
    return f();
  } catch (const std::exception& e) {
    g_error = e.what();
    return -2;
  }
}

}  // namespace

extern "C" {

uint32_t babe_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  return crc32c(crc, p, n);
}

uint64_t babe_xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  return xxh64(p, n, seed);
}

const char* babe_zstd_error(void) { return g_error.c_str(); }

// >= 0: the declared content size of all frames; -1: a frame declares
// none; -2: malformed (babe_zstd_error says why)
int64_t babe_zstd_content_size(const uint8_t* src, size_t n) {
  return guarded([&] { return content_size(src, n); });
}

// decode every frame of src into dst, which must hold exactly what they
// decode to: returns the bytes written, or -2 (babe_zstd_error says why)
int64_t babe_zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst,
                                  size_t cap) {
  return guarded([&] {
    Out out{dst, 0, cap, false};
    decode_all(src, n, out);
    return int64_t(out.len);
  });
}

// decode every frame of src into a buffer of its own (*dst, to be freed
// with babe_free): returns its size, or -2
int64_t babe_zstd_decompress(const uint8_t* src, size_t n, uint8_t** dst) {
  *dst = nullptr;
  Out out{nullptr, 0, 0, true};
  int64_t r = guarded([&] {
    decode_all(src, n, out);
    return int64_t(out.len);
  });
  if (r < 0)
    std::free(out.buf);
  else
    *dst = out.buf;
  return r;
}

void babe_free(void* p) { std::free(p); }

int babe_zstd_feature_count(void) { return F_COUNT; }

void babe_zstd_features(uint64_t* out) {
  for (int i = 0; i < F_COUNT; i++)
    out[i] = g_features[i].load(std::memory_order_relaxed);
}

}  // extern "C"
