// zf_native — C++ host runtime for zigflac_tpu.
//
// The accelerator owns the compute path (analysis, bit packing, CRC-16 of
// frames);
// this extension owns the serial host-side runtime around it, the pieces the
// reference implements natively in Zig:
//   * MD5 over the raw PCM byte stream (reference: src/Md5.zig — optionally
//     OpenSSL; here: a self-contained implementation)
//   * CRC-8/SMBUS + CRC-16/UMTS (reference: libFLAC/Crc16.zig + std tables)
//   * WAV byte de-interleave / sign-extension into planar int32
//     (reference: src/WavReader.zig:173-245)
//   * frame-stream assembly: slicing packed frame words + CRC footers into
//     one contiguous FLAC byte stream (replaces a per-frame Python loop)
//
// Built as a plain CPython extension (no pybind11) by native/build.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// MD5 (RFC 1321)
// ---------------------------------------------------------------------------

namespace md5impl {

struct Ctx {
  uint32_t a, b, c, d;
  uint64_t nbytes;
  uint8_t buf[64];
};

static const uint32_t K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                          7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                          5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                          4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                          6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                          6, 10, 15, 21};

static inline uint32_t rotl(uint32_t x, int c) {
  return (x << c) | (x >> (32 - c));
}

static void init(Ctx* c) {
  c->a = 0x67452301;
  c->b = 0xefcdab89;
  c->c = 0x98badcfe;
  c->d = 0x10325476;
  c->nbytes = 0;
}

static void block(Ctx* ctx, const uint8_t* p) {
  uint32_t m[16];
  std::memcpy(m, p, 64);  // little-endian hosts only (x86/arm64)
  uint32_t a = ctx->a, b = ctx->b, c = ctx->c, d = ctx->d;
  for (int i = 0; i < 64; i++) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + K[i] + m[g], S[i]);
    a = tmp;
  }
  ctx->a += a;
  ctx->b += b;
  ctx->c += c;
  ctx->d += d;
}

static void update(Ctx* c, const uint8_t* data, size_t len) {
  size_t fill = c->nbytes & 63;
  c->nbytes += len;
  if (fill) {
    size_t take = 64 - fill;
    if (take > len) take = len;
    std::memcpy(c->buf + fill, data, take);
    data += take;
    len -= take;
    if (fill + take == 64) block(c, c->buf);
    else return;
  }
  while (len >= 64) {
    block(c, data);
    data += 64;
    len -= 64;
  }
  if (len) std::memcpy(c->buf, data, len);
}

static void final(Ctx* c, uint8_t out[16]) {
  uint64_t bits = c->nbytes * 8;
  uint8_t pad[72] = {0x80};
  size_t fill = c->nbytes & 63;
  size_t padlen = (fill < 56) ? 56 - fill : 120 - fill;
  update(c, pad, padlen);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
  update(c, lenb, 8);
  uint32_t w[4] = {c->a, c->b, c->c, c->d};
  std::memcpy(out, w, 16);
}

}  // namespace md5impl

// ---------------------------------------------------------------------------
// CRC tables
// ---------------------------------------------------------------------------

static uint16_t crc16_table[8][256];
static uint8_t crc8_table[256];

static void init_crc_tables() {
  for (int b = 0; b < 256; b++) {
    uint16_t crc = (uint16_t)(b << 8);
    for (int i = 0; i < 8; i++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
    crc16_table[0][b] = crc;
    uint8_t c8 = (uint8_t)b;
    for (int i = 0; i < 8; i++)
      c8 = (c8 & 0x80) ? (uint8_t)((c8 << 1) ^ 0x07) : (uint8_t)(c8 << 1);
    crc8_table[b] = c8;
  }
  // slice-by-8 derivation
  for (int t = 1; t < 8; t++)
    for (int b = 0; b < 256; b++) {
      uint16_t c = crc16_table[t - 1][b];
      crc16_table[t][b] =
          (uint16_t)(crc16_table[0][(c >> 8) & 0xFF] ^ (uint16_t)(c << 8));
    }
}

static inline uint16_t crc16_update(uint16_t crc, const uint8_t* p, size_t n) {
  // slice-by-8 over the non-reflected CRC-16/UMTS
  while (n >= 8) {
    uint16_t x = crc;
    crc = (uint16_t)(crc16_table[7][p[0] ^ (x >> 8)] ^
                     crc16_table[6][p[1] ^ (x & 0xFF)] ^
                     crc16_table[5][p[2]] ^ crc16_table[4][p[3]] ^
                     crc16_table[3][p[4]] ^ crc16_table[2][p[5]] ^
                     crc16_table[1][p[6]] ^ crc16_table[0][p[7]]);
    p += 8;
    n -= 8;
  }
  while (n--) crc = (uint16_t)(crc16_table[0][((crc >> 8) ^ *p++) & 0xFF] ^
                               (uint16_t)(crc << 8));
  return crc;
}

// ---------------------------------------------------------------------------
// Python bindings
// ---------------------------------------------------------------------------

static PyObject* py_md5(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  md5impl::Ctx c;
  md5impl::init(&c);
  uint8_t out[16];
  Py_BEGIN_ALLOW_THREADS
  md5impl::update(&c, (const uint8_t*)buf.buf, (size_t)buf.len);
  md5impl::final(&c, out);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return PyBytes_FromStringAndSize((const char*)out, 16);
}

// Streaming MD5: the context travels as opaque bytes so the Python side can
// hold it without a capsule lifetime dance (Ctx is POD). Mirrors the
// reference's incremental Md5.update over streamed WAV blocks
// (src/Md5.zig + src/wav2flac.zig:64-75).
static PyObject* py_md5_init(PyObject*, PyObject*) {
  md5impl::Ctx c;
  md5impl::init(&c);
  return PyBytes_FromStringAndSize((const char*)&c, sizeof(c));
}

static PyObject* py_md5_update(PyObject*, PyObject* args) {
  Py_buffer ctxb, buf;
  if (!PyArg_ParseTuple(args, "y*y*", &ctxb, &buf)) return nullptr;
  if ((size_t)ctxb.len != sizeof(md5impl::Ctx)) {
    PyBuffer_Release(&ctxb);
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "bad md5 context size");
    return nullptr;
  }
  md5impl::Ctx c;
  memcpy(&c, ctxb.buf, sizeof(c));
  Py_BEGIN_ALLOW_THREADS
  md5impl::update(&c, (const uint8_t*)buf.buf, (size_t)buf.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&ctxb);
  PyBuffer_Release(&buf);
  return PyBytes_FromStringAndSize((const char*)&c, sizeof(c));
}

static PyObject* py_md5_final(PyObject*, PyObject* args) {
  Py_buffer ctxb;
  if (!PyArg_ParseTuple(args, "y*", &ctxb)) return nullptr;
  if ((size_t)ctxb.len != sizeof(md5impl::Ctx)) {
    PyBuffer_Release(&ctxb);
    PyErr_SetString(PyExc_ValueError, "bad md5 context size");
    return nullptr;
  }
  md5impl::Ctx c;
  memcpy(&c, ctxb.buf, sizeof(c));
  uint8_t out[16];
  md5impl::final(&c, out);
  PyBuffer_Release(&ctxb);
  return PyBytes_FromStringAndSize((const char*)out, 16);
}

static PyObject* py_crc16(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned int init = 0;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &init)) return nullptr;
  uint16_t crc;
  Py_BEGIN_ALLOW_THREADS
  crc = crc16_update((uint16_t)init, (const uint8_t*)buf.buf, (size_t)buf.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc);
}

// Ogg page CRC-32: poly 0x04C11DB7, non-reflected, init 0, no final xor
// (the container layer for Ogg-FLAC transmuxing; same slice-by-8 scheme as
// the frame CRC-16 above)
static uint32_t crc32o_table[8][256];
static void init_crc32o() {
  for (int b = 0; b < 256; b++) {
    uint32_t crc = (uint32_t)b << 24;
    for (int i = 0; i < 8; i++)
      crc = (crc & 0x80000000u) ? (crc << 1) ^ 0x04C11DB7u : crc << 1;
    crc32o_table[0][b] = crc;
  }
  for (int t = 1; t < 8; t++)
    for (int b = 0; b < 256; b++) {
      uint32_t c = crc32o_table[t - 1][b];
      crc32o_table[t][b] = crc32o_table[0][(c >> 24) & 0xFF] ^ (c << 8);
    }
}

static inline uint32_t crc32o_update(uint32_t crc, const uint8_t* p,
                                     size_t n) {
  while (n >= 8) {
    uint32_t x = crc;
    crc = crc32o_table[7][p[0] ^ ((x >> 24) & 0xFF)] ^
          crc32o_table[6][p[1] ^ ((x >> 16) & 0xFF)] ^
          crc32o_table[5][p[2] ^ ((x >> 8) & 0xFF)] ^
          crc32o_table[4][p[3] ^ (x & 0xFF)] ^ crc32o_table[3][p[4]] ^
          crc32o_table[2][p[5]] ^ crc32o_table[1][p[6]] ^
          crc32o_table[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--)
    crc = crc32o_table[0][((crc >> 24) ^ *p++) & 0xFF] ^ (crc << 8);
  return crc;
}

static PyObject* py_crc32_ogg(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned int init = 0;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &init)) return nullptr;
  uint32_t crc;
  Py_BEGIN_ALLOW_THREADS
  crc = crc32o_update((uint32_t)init, (const uint8_t*)buf.buf,
                      (size_t)buf.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc);
}

static PyObject* py_crc8(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned int init = 0;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &init)) return nullptr;
  uint8_t crc = (uint8_t)init;
  const uint8_t* p = (const uint8_t*)buf.buf;
  for (Py_ssize_t i = 0; i < buf.len; i++) crc = crc8_table[crc ^ p[i]];
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc);
}

// deinterleave(data, channels, bytes_per_sample, bit_depth) -> bytes (planar
// int32, [channels][n] C-order), replicating src/WavReader.zig:44-93
// semantics: little-endian bytes top-justified in i32, 1-byte samples get
// `-= 128 >> (8-depth)` before sign extension, then arithmetic shift by
// (32 - depth) unless depth == 32.
static PyObject* py_deinterleave(PyObject*, PyObject* args) {
  Py_buffer buf;
  int channels, nb, depth;
  if (!PyArg_ParseTuple(args, "y*iii", &buf, &channels, &nb, &depth))
    return nullptr;
  size_t frame = (size_t)channels * nb;
  size_t n = (size_t)buf.len / frame;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(n * channels * 4));
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  int32_t* dst = (int32_t*)PyBytes_AS_STRING(out);
  const uint8_t* src = (const uint8_t*)buf.buf;
  const int shift = 32 - depth;
  const int32_t sub = (nb == 1) ? (int32_t)(128 >> (8 - depth)) : 0;
  Py_BEGIN_ALLOW_THREADS
  for (int ch = 0; ch < channels; ch++) {
    int32_t* d = dst + (size_t)ch * n;
    const uint8_t* s = src + (size_t)ch * nb;
    for (size_t i = 0; i < n; i++) {
      uint32_t v = 0;
      const uint8_t* q = s + i * frame;
      for (int b = 0; b < nb; b++) v |= ((uint32_t)q[b]) << (8 * (4 - nb + b));
      // subtract in u32: v can be INT32_MIN-justified (byte 0x80), where a
      // signed subtract overflows (UB); the wrap IS the reference semantics
      int32_t x = (int32_t)(v - (uint32_t)sub);
      if (depth != 32) x >>= shift;
      d[i] = x;
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return out;
}

// assemble(words_be_bytes, stride_bytes, byte_lens_i64, crcs_u32) -> bytes
// Concatenates per-frame byte slices out of the padded word buffer and
// appends each frame's CRC-16 footer.
static PyObject* py_assemble(PyObject*, PyObject* args) {
  Py_buffer words, lens, crcs;
  Py_ssize_t stride;
  if (!PyArg_ParseTuple(args, "y*ny*y*", &words, &stride, &lens, &crcs))
    return nullptr;
  size_t nframes = (size_t)lens.len / 8;
  const int64_t* L = (const int64_t*)lens.buf;
  const uint32_t* C = (const uint32_t*)crcs.buf;
  size_t total = 0;
  for (size_t i = 0; i < nframes; i++) total += (size_t)L[i] + 2;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!out) goto fail;
  {
    uint8_t* dst = (uint8_t*)PyBytes_AS_STRING(out);
    const uint8_t* src = (const uint8_t*)words.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < nframes; i++) {
      size_t len = (size_t)L[i];
      std::memcpy(dst, src + i * (size_t)stride, len);
      dst += len;
      *dst++ = (uint8_t)(C[i] >> 8);
      *dst++ = (uint8_t)(C[i] & 0xFF);
    }
    Py_END_ALLOW_THREADS
  }
  PyBuffer_Release(&words);
  PyBuffer_Release(&lens);
  PyBuffer_Release(&crcs);
  return out;
fail:
  PyBuffer_Release(&words);
  PyBuffer_Release(&lens);
  PyBuffer_Release(&crcs);
  return nullptr;
}

// assemble_ranges(stream_bytes, word_offsets_i64, byte_lens_i64) -> bytes
// Tightens a word-aligned concatenated frame stream: frame f's bytes start
// at stream[4*woff[f]] and run byte_lens[f]; drop the <=3 pad bytes between.
static PyObject* py_assemble_ranges(PyObject*, PyObject* args) {
  Py_buffer stream, offs, lens;
  if (!PyArg_ParseTuple(args, "y*y*y*", &stream, &offs, &lens)) return nullptr;
  size_t nframes = (size_t)lens.len / 8;
  const int64_t* O = (const int64_t*)offs.buf;
  const int64_t* L = (const int64_t*)lens.buf;
  size_t total = 0;
  for (size_t i = 0; i < nframes; i++) total += (size_t)L[i];
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!out) {
    PyBuffer_Release(&stream);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&lens);
    return nullptr;
  }
  uint8_t* dst = (uint8_t*)PyBytes_AS_STRING(out);
  const uint8_t* src = (const uint8_t*)stream.buf;
  Py_BEGIN_ALLOW_THREADS
  for (size_t i = 0; i < nframes; i++) {
    std::memcpy(dst, src + 4 * (size_t)O[i], (size_t)L[i]);
    dst += (size_t)L[i];
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&stream);
  PyBuffer_Release(&offs);
  PyBuffer_Release(&lens);
  return out;
}

// ---------------------------------------------------------------------------
// FLAC frame batch parser (the decoder's serial host stage)
// ---------------------------------------------------------------------------
// The bit-serial part of decoding — sync/header fields, subframe headers,
// Rice/unary residual extraction — is inherently sequential, so it lives
// here, mirroring the encoder split (serial WAV feed on host, arithmetic on
// device). Every subframe type is normalized to one predictor form the
// device synthesis scan consumes: values[] (warmup samples then residuals,
// or literal samples), qcoeffs[32] (int, q[j] multiplies s[i-1-j]),
// shift, order, wasted. Constant/verbatim become order-0 literals; fixed
// orders use the binomial coefficients with shift 0 (libFLAC/fixed.zig).

namespace frameparse {

// 64-bit-window bit reader: bits live left-justified in `buf` with `avail`
// valid top bits (the invariant: bits below the top `avail` are ZERO), the
// window refills 8 bytes at a time via one byte-swapped load, and unary
// (Rice quotient) scanning counts leading zeros with clz instead of testing
// bit-by-bit. This is the decode-side hot loop — every residual bit of a
// stream passes through here — and the window design lifted the all-native
// decode path several-fold over the per-bit reader it replaced.
struct BitRd {
  const uint8_t* d;
  size_t len;    // total bytes
  uint64_t buf;  // left-justified bit window
  int avail;     // valid top bits in buf
  size_t next;   // next byte index to pull into the window
  bool ok;

  BitRd(const uint8_t* data, size_t n, size_t start_bit)
      : d(data), len(n), buf(0), avail(0), next(start_bit >> 3), ok(true) {
    int skip = (int)(start_bit & 7);
    if (skip) {
      refill();
      if (avail >= skip) {
        buf <<= skip;
        avail -= skip;
      } else {
        fail();
      }
    }
  }

  inline void fail() {
    ok = false;
    buf = 0;
    avail = 0;
    next = len;  // bitpos() lands at end-of-data; callers stop cleanly
  }

  inline void refill() {
    if (next + 8 <= len) {
      int take = (64 - avail) >> 3;  // whole bytes that fit in the window
      if (take) {
        uint64_t v;
        std::memcpy(&v, d + next, 8);
        v = __builtin_bswap64(v);
        if (take < 8) v &= ~0ull << (64 - 8 * take);  // keep invariant
        buf |= v >> avail;
        next += (size_t)take;
        avail += 8 * take;
      }
      return;
    }
    while (avail <= 56 && next < len) {
      buf |= (uint64_t)d[next++] << (56 - avail);
      avail += 8;
    }
  }

  inline size_t bitpos() const { return (next << 3) - (size_t)avail; }

  inline uint64_t read64(int n) {  // 0 <= n <= 57, MSB-first
    if (n == 0) return 0;
    if (avail < n) {
      refill();
      if (avail < n) {
        fail();
        return 0;
      }
    }
    uint64_t v = buf >> (64 - n);
    buf <<= n;
    avail -= n;
    return v;
  }
  inline uint32_t read(int n) { return (uint32_t)read64(n); }
  inline int64_t read_signed(int n) {  // n <= 57 (max field is 33)
    if (n == 0) return 0;
    uint64_t v = read64(n);
    if (v & (1ull << (n - 1))) v -= (1ull << n);
    return (int64_t)v;
  }
  inline uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if (avail == 0) {
        refill();
        if (avail == 0) {
          fail();
          return 0;
        }
      }
      if (buf == 0) {  // every valid window bit is zero: consume them all
        q += (uint32_t)avail;
        avail = 0;
        if (q > (1u << 24)) {  // corrupt-stream guard
          fail();
          return 0;
        }
        continue;
      }
      int z = __builtin_clzll(buf);
      if (z >= avail) {  // zeros run to the window edge
        q += (uint32_t)avail;
        buf = 0;
        avail = 0;
        continue;
      }
      // consume zeros + stop bit in TWO shifts: z + 1 can be 64 when a
      // 63-zero run ends at the last bit of a full window, and a single
      // 64-bit shift-by-64 is UB — x86 masks the count to 0, leaving the
      // consumed stop bit as a stale 1 in the "empty" window that later
      // surfaces inside a value read (found by tools/fuzz_long.py: one
      // Rice remainder off by a single bit, CRC still passing because
      // the reader consumed the right COUNT of bits)
      buf <<= z;
      buf <<= 1;
      avail -= z + 1;
      return q + (uint32_t)z;
    }
  }
  inline void align_byte() {
    int rem = (int)(bitpos() & 7);
    if (rem) read64(8 - rem);
  }

  // One whole Rice code (unary quotient + stop bit + k remainder bits)
  // from a single window when it fits — the common case by a wide margin
  // (typical k ~ 5-12, quotient 0-3, so ~7-16 bits against a >= 34-bit
  // window). One refill check + one avail update per sample instead of
  // the read_unary/read pair's two to four; falls back to the exact
  // slow path at window boundaries and long unary runs. Returns the
  // zigzag-DECODED residual.
  inline int64_t read_rice(int k) {
    if (avail <= 40) refill();  // fast path needs z + 1 + k <= avail
    int z = buf ? __builtin_clzll(buf) : 64;
    if (z + 1 + k <= avail) {
      // consume z zeros + the stop bit in two shifts (z + 1 == 64 when
      // a 63-zero run fills the window: single shift-by-64 is UB)
      uint64_t rest = (buf << z) << 1;
      uint64_t zz = ((uint64_t)(uint32_t)z << k) |
                    (k ? rest >> (64 - k) : 0);
      buf = k ? rest << k : rest;
      avail -= z + 1 + k;
      return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
    }
    uint64_t q = read_unary();
    uint64_t zz = (q << k) | (k ? read64(k) : 0);
    return (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
  }
};

static const int64_t FIXED_Q[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

// residuals for one subframe into out[pred_order..block_size)
static bool residual_partitions(BitRd& r, int64_t* out, int block_size,
                                int pred_order) {
  uint32_t method = r.read(2);
  if (!r.ok || method > 1) return false;
  int plen = 4 + (int)method;
  uint32_t escape = (1u << plen) - 1;
  uint32_t po = r.read(4);
  int idx = pred_order;
  for (uint32_t p = 0; p < (1u << po); p++) {
    int psz = block_size >> po;
    if (p == 0) psz -= pred_order;
    if (psz < 0 || idx + psz > block_size) return false;
    uint32_t param = r.read(plen);
    if (!r.ok) return false;
    if (param == escape) {
      uint32_t bps = r.read(5);
      if (bps == 0) {
        for (int i = 0; i < psz; i++) out[idx++] = 0;
      } else {
        for (int i = 0; i < psz; i++) out[idx++] = r.read_signed((int)bps);
      }
    } else {
      int k = (int)param;
      for (int i = 0; i < psz; i++) out[idx++] = r.read_rice(k);
    }
    if (!r.ok) return false;
  }
  return idx == block_size;
}

struct SubframeOut {
  int64_t* values;   // [B]
  int64_t* qcoeffs;  // [32]
  int32_t shift, order, wasted;
};

static bool parse_subframe(BitRd& r, int block_size, int sample_size,
                           SubframeOut& o) {
  if (r.read(1) != 0 || !r.ok) return false;
  uint32_t type = r.read(6);
  o.wasted = 0;
  if (r.read(1) == 1) {
    o.wasted = 1 + (int32_t)r.read_unary();
    sample_size -= o.wasted;
    if (sample_size <= 0) return false;
  }
  if (!r.ok) return false;
  std::memset(o.qcoeffs, 0, 32 * sizeof(int64_t));
  o.shift = 0;
  if (type == 0) {  // constant
    int64_t v = r.read_signed(sample_size);
    for (int i = 0; i < block_size; i++) o.values[i] = v;
    o.order = 0;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; i++)
      o.values[i] = r.read_signed(sample_size);
    o.order = 0;
  } else if (type >= 8 && type <= 12) {  // fixed
    int order = (int)(type & 7);
    if (order > block_size) return false;
    for (int i = 0; i < order; i++) o.values[i] = r.read_signed(sample_size);
    for (int j = 0; j < order; j++) o.qcoeffs[j] = FIXED_Q[order][j];
    o.order = order;
    if (!residual_partitions(r, o.values, block_size, order)) return false;
  } else if (type >= 32) {  // LPC
    int order = (int)(type & 31) + 1;
    if (order > block_size) return false;
    for (int i = 0; i < order; i++) o.values[i] = r.read_signed(sample_size);
    int precision = (int)r.read(4) + 1;
    if (precision == 16) return false;
    int64_t shift = r.read_signed(5);
    if (shift < 0) return false;
    o.shift = (int32_t)shift;
    for (int j = 0; j < order; j++) o.qcoeffs[j] = r.read_signed(precision);
    o.order = order;
    if (!residual_partitions(r, o.values, block_size, order)) return false;
  } else {
    return false;
  }
  return r.ok;
}

static const int BSIZE_CODES[16] = {-1, 192,  576,  1152, 2304, 4608, -6, -7,
                                    256, 512, 1024, 2048, 4096, 8192, 16384,
                                    32768};
static const int DEPTH_CODES[16] = {0, -1, 8, -1, 12, -1, -1, -1,
                                    16, -1, 20, -1, 24, -1, 32, -1};

struct FrameHdr {
  int bs = 0;            // block size
  int depth = 0;         // bit depth after streaminfo fallback
  uint32_t ch_code = 0;
  int64_t fn = 0;
  bool crc8_ok = false;
};

// Parse one frame header (sync through CRC-8) at byte `pos`; `r` must be
// freshly positioned there. Returns nullptr on success or an error string.
static const char* parse_frame_header(BitRd& r, const uint8_t* data,
                                      size_t pos, int sinfo_depth,
                                      int channels, FrameHdr& h) {
  uint32_t sync = r.read(14);
  if (!r.ok || sync != 0x3FFE) return "bad frame sync";
  r.read(1);
  r.read(1);
  uint32_t bs_code = r.read(4);
  uint32_t sr_code = r.read(4);
  h.ch_code = r.read(4);
  uint32_t depth_code = r.read(4);
  {  // UTF-8 coded frame number
    uint32_t first = r.read(8);
    if (first < 0x80) {
      h.fn = first;
    } else {
      int ncont = 0;
      uint32_t mask = 0x40;
      while (first & mask) { ncont++; mask >>= 1; }
      int64_t v = first & (mask - 1);
      for (int i = 0; i < ncont; i++) {
        uint32_t b = r.read(8);
        if ((b & 0xC0) != 0x80) { r.ok = false; break; }
        v = (v << 6) | (b & 0x3F);
      }
      h.fn = v;
    }
    if (!r.ok) return "bad UTF-8 frame number";
  }
  if (bs_code == 6) h.bs = (int)r.read(8) + 1;
  else if (bs_code == 7) h.bs = (int)r.read(16) + 1;
  else if (BSIZE_CODES[bs_code] > 0) h.bs = BSIZE_CODES[bs_code];
  else return "reserved block size code";
  if (sr_code == 12) r.read(8);
  else if (sr_code == 13 || sr_code == 14) r.read(16);
  if (!r.ok) return "truncated header";

  size_t header_end = r.bitpos() >> 3;
  uint8_t c8 = 0;
  for (size_t i = pos; i < header_end; i++) c8 = crc8_table[c8 ^ data[i]];
  uint32_t got8 = r.read(8);
  h.crc8_ok = r.ok && got8 == c8;
  h.depth = DEPTH_CODES[depth_code];
  if (h.depth < 0) return "unsupported depth code";
  if (h.depth == 0) h.depth = sinfo_depth;

  if (h.ch_code <= 7) {
    if ((int)h.ch_code + 1 != channels) return "channel count mismatch";
  } else if (h.ch_code <= 10) {
    if (channels != 2) return "stereo decorrelation on non-stereo";
  } else {
    return "reserved channel code";
  }
  return nullptr;
}

}  // namespace frameparse

// parse_frames(data, start, max_frames, sinfo_depth, channels)
//   -> (nframes, end_pos, block_size, values, qcoeffs, shift_order_wasted,
//       chcode, fnum, crc_ok)
// Parses consecutive frames sharing one block size (stops early at a frame
// with a different block size — the caller re-invokes for the tail). All
// output buffers are bytes in C order:
//   values  i64 [n, C, B]    qcoeffs i64 [n, C, 32]
//   sow     i32 [n, C, 3]    (shift, order, wasted)
//   chcode  i32 [n]          fnum i64 [n]        crc_ok u8 [n]
static PyObject* py_parse_frames(PyObject*, PyObject* args) {
  Py_buffer buf;
  Py_ssize_t start, max_frames;
  int sinfo_depth, channels;
  if (!PyArg_ParseTuple(args, "y*nnii", &buf, &start, &max_frames,
                        &sinfo_depth, &channels))
    return nullptr;
  using namespace frameparse;
  const uint8_t* data = (const uint8_t*)buf.buf;
  size_t len = (size_t)buf.len;

  std::vector<int64_t> values, qcoeffs;
  std::vector<int32_t> sow, chcode;
  std::vector<int64_t> fnum;
  std::vector<int64_t> fend;  // byte offset just past each frame
  std::vector<uint8_t> crc_ok;
  int batch_bs = -1;
  size_t pos = (size_t)start;
  int nframes = 0;
  const char* err = nullptr;

  Py_BEGIN_ALLOW_THREADS
  while (nframes < max_frames && pos + 2 <= len) {
    BitRd r(data, len, pos * 8);
    FrameHdr h;
    err = parse_frame_header(r, data, pos, sinfo_depth, channels, h);
    if (err) break;
    if (batch_bs < 0) batch_bs = h.bs;
    else if (h.bs != batch_bs) { err = nullptr; break; }  // tail frame
    bool crc_good = h.crc8_ok;
    int depth = h.depth;
    uint32_t ch_code = h.ch_code;
    int64_t fn = h.fn;
    int C = channels;

    size_t vbase = values.size();
    values.resize(vbase + (size_t)C * batch_bs, 0);
    size_t qbase = qcoeffs.size();
    qcoeffs.resize(qbase + (size_t)C * 32, 0);
    size_t sbase = sow.size();
    sow.resize(sbase + (size_t)C * 3, 0);

    bool frame_ok = true;
    for (int ch = 0; ch < C && frame_ok; ch++) {
      int ss = depth;
      if (ch_code == 8 && ch == 1) ss = depth + 1;   // left-side: side
      if (ch_code == 9 && ch == 0) ss = depth + 1;   // side-right: side
      if (ch_code == 10 && ch == 1) ss = depth + 1;  // mid-side: side
      SubframeOut o;
      o.values = values.data() + vbase + (size_t)ch * batch_bs;
      o.qcoeffs = qcoeffs.data() + qbase + (size_t)ch * 32;
      frame_ok = parse_subframe(r, batch_bs, ss, o);
      if (frame_ok) {
        int32_t* s = sow.data() + sbase + (size_t)ch * 3;
        s[0] = o.shift; s[1] = o.order; s[2] = o.wasted;
      }
    }
    if (!frame_ok) {
      values.resize(vbase);
      qcoeffs.resize(qbase);
      sow.resize(sbase);
      err = "bad subframe";
      break;
    }
    // byte-align, CRC-16 footer
    r.align_byte();
    size_t body_end = r.bitpos() >> 3;
    if (body_end + 2 > len) {
      values.resize(vbase);
      qcoeffs.resize(qbase);
      sow.resize(sbase);
      err = "truncated frame";
      break;
    }
    uint16_t c16 = crc16_update(0, data + pos, body_end - pos);
    uint32_t got16 = r.read(16);
    crc_good = crc_good && r.ok && got16 == c16;

    chcode.push_back((int32_t)ch_code);
    fnum.push_back(fn);
    crc_ok.push_back(crc_good ? 1 : 0);
    pos = body_end + 2;
    fend.push_back((int64_t)pos);
    nframes++;
  }
  Py_END_ALLOW_THREADS

  if (nframes == 0 && err) {
    PyErr_SetString(PyExc_ValueError, err);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  PyBuffer_Release(&buf);
  PyObject* pv = PyBytes_FromStringAndSize(
      (const char*)values.data(), (Py_ssize_t)(values.size() * 8));
  PyObject* pq = PyBytes_FromStringAndSize(
      (const char*)qcoeffs.data(), (Py_ssize_t)(qcoeffs.size() * 8));
  PyObject* ps = PyBytes_FromStringAndSize(
      (const char*)sow.data(), (Py_ssize_t)(sow.size() * 4));
  PyObject* pc = PyBytes_FromStringAndSize(
      (const char*)chcode.data(), (Py_ssize_t)(chcode.size() * 4));
  PyObject* pf = PyBytes_FromStringAndSize(
      (const char*)fnum.data(), (Py_ssize_t)(fnum.size() * 8));
  PyObject* pk = PyBytes_FromStringAndSize(
      (const char*)crc_ok.data(), (Py_ssize_t)crc_ok.size());
  PyObject* pe = PyBytes_FromStringAndSize(
      (const char*)fend.data(), (Py_ssize_t)(fend.size() * 8));
  return Py_BuildValue("(nnnNNNNNNN)", (Py_ssize_t)nframes, (Py_ssize_t)pos,
                       (Py_ssize_t)(batch_bs < 0 ? 0 : batch_bs), pv, pq, ps,
                       pc, pf, pk, pe);
}

// In-place IIR update o[i] += (sum_j q[j] * o[i-1-j]) >> shift for
// i in [order, B): the decode-side arithmetic hot loop. The templated
// forms keep the `order`-deep history in registers (a rotating local
// array the compiler fully unrolls), so each sample costs `order`
// multiply-adds with no reloads of just-written samples; the generic
// fallback covers rare high orders. shift is 0 for fixed predictors.
template <int ORDER>
static inline void iir_inplace_t(int64_t* o, Py_ssize_t B, const int64_t* q,
                                 int shift) {
  if (B <= ORDER) return;
  int64_t h[ORDER];
  int64_t c[ORDER];
  for (int j = 0; j < ORDER; j++) {
    h[j] = o[ORDER - 1 - j];
    c[j] = q[j];
  }
  for (Py_ssize_t i = ORDER; i < B; i++) {
    int64_t pred = 0;
    for (int j = 0; j < ORDER; j++) pred += c[j] * h[j];
    int64_t s = o[i] + (pred >> shift);
    for (int j = ORDER - 1; j > 0; j--) h[j] = h[j - 1];
    h[0] = s;
    o[i] = s;
  }
}

static inline void iir_inplace(int64_t* o, Py_ssize_t B, const int64_t* q,
                               int order, int shift) {
  switch (order) {
    case 0: return;
    case 1: return iir_inplace_t<1>(o, B, q, shift);
    case 2: return iir_inplace_t<2>(o, B, q, shift);
    case 3: return iir_inplace_t<3>(o, B, q, shift);
    case 4: return iir_inplace_t<4>(o, B, q, shift);
    case 5: return iir_inplace_t<5>(o, B, q, shift);
    case 6: return iir_inplace_t<6>(o, B, q, shift);
    case 7: return iir_inplace_t<7>(o, B, q, shift);
    case 8: return iir_inplace_t<8>(o, B, q, shift);
    case 9: return iir_inplace_t<9>(o, B, q, shift);
    case 10: return iir_inplace_t<10>(o, B, q, shift);
    case 11: return iir_inplace_t<11>(o, B, q, shift);
    case 12: return iir_inplace_t<12>(o, B, q, shift);
    default:
      for (Py_ssize_t i = order; i < B; i++) {
        int64_t pred = 0;
        for (int j = 0; j < order; j++) pred += q[j] * o[i - 1 - j];
        o[i] += pred >> shift;
      }
  }
}

// synthesize(values, qcoeffs, sow, chcode, n, C, B) -> bytes (i64 samples,
// [n][C][B] C-order). Host IIR synthesis + stereo recombination over the
// normalized predictor form parse_frames emits — the all-native decode path
// (the device scan path computes the identical samples; tests assert so).
static PyObject* py_synthesize(PyObject*, PyObject* args) {
  Py_buffer vb, qb, sb, cb;
  Py_ssize_t n, C, B;
  if (!PyArg_ParseTuple(args, "y*y*y*y*nnn", &vb, &qb, &sb, &cb, &n, &C, &B))
    return nullptr;
  // the buffers come from Python callers: validate every length against the
  // claimed geometry before touching raw pointers
  if (n < 0 || C < 0 || B < 0 || vb.len != n * C * B * 8 ||
      qb.len != n * C * 32 * 8 || sb.len != n * C * 3 * 4 || cb.len != n * 4) {
    PyBuffer_Release(&vb); PyBuffer_Release(&qb);
    PyBuffer_Release(&sb); PyBuffer_Release(&cb);
    PyErr_SetString(PyExc_ValueError, "synthesize: buffer/geometry mismatch");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr,
                                            (Py_ssize_t)(n * C * B * 8));
  if (!out) {
    PyBuffer_Release(&vb); PyBuffer_Release(&qb);
    PyBuffer_Release(&sb); PyBuffer_Release(&cb);
    return nullptr;
  }
  int64_t* dst = (int64_t*)PyBytes_AS_STRING(out);
  const int64_t* values = (const int64_t*)vb.buf;
  const int64_t* qco = (const int64_t*)qb.buf;
  const int32_t* sow = (const int32_t*)sb.buf;
  const int32_t* chc = (const int32_t*)cb.buf;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t f = 0; f < n; f++) {
    for (Py_ssize_t ch = 0; ch < C; ch++) {
      const int64_t* v = values + (f * C + ch) * B;
      const int64_t* q = qco + (f * C + ch) * 32;
      const int32_t* s = sow + (f * C + ch) * 3;
      int64_t* o = dst + (f * C + ch) * B;
      const int shift = s[0];
      const int order = s[1];
      const int wasted = s[2];
      std::memcpy(o, v, (size_t)B * sizeof(int64_t));
      iir_inplace(o, B, q, order, shift);
      if (wasted)
        for (Py_ssize_t i = 0; i < B; i++) o[i] <<= wasted;
    }
    if (C == 2 && chc[f] >= 8) {  // stereo recombination
      int64_t* a = dst + (f * 2 + 0) * B;
      int64_t* b = dst + (f * 2 + 1) * B;
      if (chc[f] == 8) {          // left-side: (left, side) -> (l, l - s)
        for (Py_ssize_t i = 0; i < B; i++) b[i] = a[i] - b[i];
      } else if (chc[f] == 9) {   // side-right: (side, right) -> (s + r, r)
        for (Py_ssize_t i = 0; i < B; i++) a[i] = a[i] + b[i];
      } else if (chc[f] == 10) {  // mid-side
        for (Py_ssize_t i = 0; i < B; i++) {
          int64_t mid = a[i], side = b[i];
          int64_t left = mid + ((side + (side & 1)) >> 1);
          a[i] = left;
          b[i] = left - side;
        }
      }
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&vb); PyBuffer_Release(&qb);
  PyBuffer_Release(&sb); PyBuffer_Release(&cb);
  return out;
}

// ---------------------------------------------------------------------------
// Fused frame-span decode — shared by the serial entry (decode_frames_pcm)
// and the frame-parallel workers (decode_frames_pcm_mt). One pass per frame:
// parse + IIR synthesis + stereo recombination + interleaved little-endian
// WAV-container PCM emission in cache-resident buffers (replaces the
// parse_frames -> synthesize -> numpy-serialize pipeline's three full passes
// over [n, C, B] int64 arrays with one pass that only ever touches the 10x
// smaller container-width output).
//   pcm: [m, C] samples, stride (depth+7)/8 bytes LE, left-justified for
//     non-byte-aligned depths, +128 offset for the 1-byte container
//     (exactly wav.wav_pcm_bytes' layout).
// Per-frame end positions / CRC flags / max|sample| are recorded so the
// parallel stitcher can truncate and chain spans exactly.
// ---------------------------------------------------------------------------
struct SpanAcc {
  std::vector<uint8_t> pcm;     // container-serialized PCM, frame-major
  std::vector<size_t> fend;     // byte position just past frame i's CRC-16
  std::vector<uint8_t> fcrc;    // frame i header CRC-8 + frame CRC-16 good
  std::vector<uint64_t> fmax;   // max |sample| within frame i
  size_t start = 0, pos = 0;
  int batch_bs = -1;            // block size locked by the first frame
  int nframes = 0;
  const char* err = nullptr;    // set when parsing stopped on a bad frame
};

// Decode consecutive same-block-size frames from byte `start`, stopping at
// `stop_at` (a worker's span bound), on a block-size change (tail frame), a
// parse error, EOF, or the frame budget. `forced_bs` < 0 lets the first
// frame lock the block size (the serial entry); workers and serial resumes
// pass the already-known batch block size so a differing frame stops the
// span exactly like the serial loop would.
static void decode_span(const uint8_t* data, size_t len, size_t start,
                        Py_ssize_t max_frames, int sinfo_depth, int channels,
                        size_t stop_at, int forced_bs, SpanAcc& acc) {
  using namespace frameparse;
  acc.start = start;
  acc.batch_bs = forced_bs;
  std::vector<int64_t> vals;   // [C * B] per-frame synthesis buffer
  int64_t qco[8 * 32];         // up to 8 channels
  int32_t sow[8 * 3];
  const int nb = (sinfo_depth + 7) / 8;
  const int pad = 8 * nb - sinfo_depth;
  size_t pos = start;
  if (acc.batch_bs > 0) vals.resize((size_t)channels * acc.batch_bs);

  while ((Py_ssize_t)acc.nframes < max_frames && pos + 2 <= len &&
         pos < stop_at) {
    BitRd r(data, len, pos * 8);
    FrameHdr h;
    acc.err = parse_frame_header(r, data, pos, sinfo_depth, channels, h);
    if (acc.err) break;
    if (acc.batch_bs < 0) {
      acc.batch_bs = h.bs;
      vals.resize((size_t)channels * acc.batch_bs);
      Py_ssize_t cap = max_frames < 4096 ? max_frames : 4096;
      acc.pcm.reserve((size_t)cap * channels * acc.batch_bs * nb);
    } else if (h.bs != acc.batch_bs) {
      break;  // tail frame: the caller's next call handles it
    }
    const int C = channels;
    const int B = acc.batch_bs;

    bool frame_ok = true;
    for (int ch = 0; ch < C && frame_ok; ch++) {
      int ss = h.depth;
      if (h.ch_code == 8 && ch == 1) ss = h.depth + 1;   // left-side: side
      if (h.ch_code == 9 && ch == 0) ss = h.depth + 1;   // side-right: side
      if (h.ch_code == 10 && ch == 1) ss = h.depth + 1;  // mid-side: side
      SubframeOut o;
      o.values = vals.data() + (size_t)ch * B;
      o.qcoeffs = qco + ch * 32;
      frame_ok = parse_subframe(r, B, ss, o);
      if (frame_ok) {
        int32_t* s = sow + ch * 3;
        s[0] = o.shift; s[1] = o.order; s[2] = o.wasted;
      }
    }
    if (!frame_ok) { acc.err = "bad subframe"; break; }
    r.align_byte();
    size_t body_end = r.bitpos() >> 3;
    if (body_end + 2 > len) { acc.err = "truncated frame"; break; }
    uint16_t c16 = crc16_update(0, data + pos, body_end - pos);
    uint32_t got16 = r.read(16);
    bool crc_good = h.crc8_ok && r.ok && got16 == c16;

    // in-place IIR synthesis per channel (cache-resident: C*B int64)
    for (int ch = 0; ch < C; ch++) {
      int64_t* o = vals.data() + (size_t)ch * B;
      const int64_t* q = qco + ch * 32;
      const int shift = sow[ch * 3 + 0];
      const int order = sow[ch * 3 + 1];
      const int wasted = sow[ch * 3 + 2];
      iir_inplace(o, B, q, order, shift);
      if (wasted)
        for (int i = 0; i < B; i++) o[i] <<= wasted;
    }
    if (C == 2 && h.ch_code >= 8) {  // stereo recombination
      int64_t* a = vals.data();
      int64_t* b = vals.data() + B;
      if (h.ch_code == 8) {          // left-side -> (l, l - s)
        for (int i = 0; i < B; i++) b[i] = a[i] - b[i];
      } else if (h.ch_code == 9) {   // side-right -> (s + r, r)
        for (int i = 0; i < B; i++) a[i] = a[i] + b[i];
      } else {                       // mid-side
        for (int i = 0; i < B; i++) {
          int64_t mid = a[i], side = b[i];
          int64_t left = mid + ((side + (side & 1)) >> 1);
          a[i] = left;
          b[i] = left - side;
        }
      }
    }

    // interleave + serialize to the WAV container in one pass
    uint64_t fm = 0;
    size_t obase = acc.pcm.size();
    acc.pcm.resize(obase + (size_t)B * C * nb);
    uint8_t* dst = acc.pcm.data() + obase;
    if (nb == 2 && pad == 0) {  // 16-bit fast path (the common case)
      int16_t* d16 = (int16_t*)dst;
      for (int i = 0; i < B; i++)
        for (int ch = 0; ch < C; ch++) {
          int64_t v = vals[(size_t)ch * B + i];
          uint64_t a = (uint64_t)(v < 0 ? -v : v);
          if (a > fm) fm = a;
          d16[(size_t)i * C + ch] = (int16_t)v;
        }
    } else {
      for (int i = 0; i < B; i++)
        for (int ch = 0; ch < C; ch++) {
          int64_t v = vals[(size_t)ch * B + i];
          uint64_t a = (uint64_t)(v < 0 ? -v : v);
          if (a > fm) fm = a;
          uint64_t u = (uint64_t)(v << pad) + (nb == 1 ? 128u : 0u);
          for (int by = 0; by < nb; by++) *dst++ = (uint8_t)(u >> (8 * by));
        }
    }

    pos = body_end + 2;
    acc.fend.push_back(pos);
    acc.fcrc.push_back(crc_good ? 1 : 0);
    acc.fmax.push_back(fm);
    acc.nframes++;
  }
  acc.pos = pos;
}

// Scan [from, to) for plausible frame starts: sync code + a fully parsed
// header whose CRC-8 checks out. False positives (Rice data that happens to
// look like a valid header) survive at ~2^-22 per byte; the stitcher below
// verifies every span chains exactly and falls back to serial decode from
// the last verified boundary, so a false candidate costs time, never bytes.
static void scan_sync(const uint8_t* data, size_t len, size_t from, size_t to,
                      int sinfo_depth, int channels,
                      std::vector<size_t>& out) {
  using namespace frameparse;
  if (to > len) to = len;
  if (to < 2) return;
  for (size_t p = from; p + 2 <= to; p++) {
    if (data[p] != 0xFF || (data[p + 1] & 0xFC) != 0xF8) continue;
    BitRd r(data, len, p * 8);
    FrameHdr h;
    if (parse_frame_header(r, data, p, sinfo_depth, channels, h) == nullptr &&
        h.crc8_ok)
      out.push_back(p);
  }
}

// Package a decoded span as the public result tuple:
//   (nframes, end_pos, block_size, pcm_bytes, crc_bad_index, maxabs)
//   crc_bad_index: first frame with a CRC-8/CRC-16 mismatch, or -1.
//   maxabs: max |sample| seen (caller guards synthesis divergence).
static PyObject* span_result(const SpanAcc& acc) {
  Py_ssize_t crc_bad = -1;
  uint64_t maxabs = 0;
  for (int i = 0; i < acc.nframes; i++) {
    if (!acc.fcrc[i] && crc_bad < 0) crc_bad = i;
    if (acc.fmax[i] > maxabs) maxabs = acc.fmax[i];
  }
  PyObject* pb = PyBytes_FromStringAndSize((const char*)acc.pcm.data(),
                                           (Py_ssize_t)acc.pcm.size());
  return Py_BuildValue("(nnnNnK)", (Py_ssize_t)acc.nframes,
                       (Py_ssize_t)acc.pos,
                       (Py_ssize_t)(acc.batch_bs < 0 ? 0 : acc.batch_bs), pb,
                       crc_bad, (unsigned long long)maxabs);
}

// decode_frames_pcm(data, start, max_frames, sinfo_depth, channels)
//   -> (nframes, end_pos, block_size, pcm_bytes, crc_bad_index, maxabs)
// The all-native serial flac2wav hot path (see decode_span above).
static PyObject* py_decode_frames_pcm(PyObject*, PyObject* args) {
  Py_buffer buf;
  Py_ssize_t start, max_frames;
  int sinfo_depth, channels;
  if (!PyArg_ParseTuple(args, "y*nnii", &buf, &start, &max_frames,
                        &sinfo_depth, &channels))
    return nullptr;
  SpanAcc acc;
  Py_BEGIN_ALLOW_THREADS
  decode_span((const uint8_t*)buf.buf, (size_t)buf.len, (size_t)start,
              max_frames, sinfo_depth, channels, (size_t)buf.len, -1, acc);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  if (acc.nframes == 0 && acc.err) {
    PyErr_SetString(PyExc_ValueError, acc.err);
    return nullptr;
  }
  return span_result(acc);
}

// decode_frames_pcm_mt(data, start, max_frames, sinfo_depth, channels,
//                      nthreads) -> same tuple as decode_frames_pcm.
// Frame-parallel fused decode. FLAC frames are independent once their byte
// boundaries are known, but a boundary only falls out of a full parse — so
// workers start at *candidate* boundaries (sync code + valid CRC-8 header,
// scan_sync above) and the stitcher verifies the spans chain exactly
// (worker t's end byte == worker t+1's start byte). Any mismatch — a false
// sync, a tail frame, a parse error — discards the unverified suffix and
// re-decodes serially from the last verified byte, so the result is
// byte-identical to the serial path by construction. (Tests force 2-3
// threads on the 1-core CI host for correctness; the speedup target is real
// multi-core hosts — ROADMAP item 4.)
static PyObject* py_decode_frames_pcm_mt(PyObject*, PyObject* args) {
  Py_buffer buf;
  Py_ssize_t start, max_frames;
  int sinfo_depth, channels, nthreads;
  if (!PyArg_ParseTuple(args, "y*nniii", &buf, &start, &max_frames,
                        &sinfo_depth, &channels, &nthreads))
    return nullptr;
  const uint8_t* data = (const uint8_t*)buf.buf;
  const size_t len = (size_t)buf.len;
  SpanAcc out;
  Py_BEGIN_ALLOW_THREADS
  bool done = false;
  // clamp the user-controllable worker count: unbounded values risk
  // std::system_error from std::thread under resource exhaustion (the cap
  // stays well above any useful core count, and above the 2-16 range the
  // fuzz sweep exercises on purpose even on 1-core hosts)
  if (nthreads > 256) nthreads = 256;
  if (nthreads > 1 && max_frames > 1) {
    // one serial frame to learn the block size + a frame-size estimate
    SpanAcc probe;
    decode_span(data, len, (size_t)start, 1, sinfo_depth, channels, len, -1,
                probe);
    if (probe.nframes == 1) {
      const int gbs = probe.batch_bs;
      const int nb = (sinfo_depth + 7) / 8;
      const size_t stride = (size_t)gbs * channels * nb;
      // scan window: a generous bound on the batch's byte extent from the
      // first frame's size (underestimating only costs parallelism — the
      // serial finish below covers whatever the spans don't)
      const size_t f0 = probe.fend[0] - (size_t)start;
      const Py_ssize_t mf = max_frames < 1000000 ? max_frames : 1000000;
      size_t scan_to =
          (size_t)start + (size_t)mf * (f0 + f0 / 2 + 64) + 4096;
      if (scan_to > len || scan_to < (size_t)start) scan_to = len;
      std::vector<size_t> cand;
      scan_sync(data, len, (size_t)start + 1, scan_to, sinfo_depth, channels,
                cand);
      std::vector<size_t> bnd{(size_t)start};
      for (int t = 1; t < nthreads; t++) {
        size_t target = (size_t)start +
                        (scan_to - (size_t)start) * (size_t)t / (size_t)nthreads;
        auto it = std::lower_bound(cand.begin(), cand.end(), target);
        if (it == cand.end()) break;
        if (*it > bnd.back()) bnd.push_back(*it);
      }
      const int W = (int)bnd.size();
      if (W > 1) {
        std::vector<SpanAcc> accs(W);
        std::vector<std::thread> th;
        bool spawned = true;
        try {
          for (int t = 0; t < W; t++) {
            const size_t b = bnd[t];
            const size_t e = t + 1 < W ? bnd[t + 1] : len;
            SpanAcc* acc = &accs[t];
            th.emplace_back([=]() {
              decode_span(data, len, b, max_frames, sinfo_depth, channels, e,
                          gbs, *acc);
            });
          }
        } catch (...) {
          // std::thread construction can throw under resource exhaustion;
          // join whatever started and fall back to the serial path (`out`
          // is untouched here, so the fallback decodes from scratch)
          spawned = false;
        }
        for (auto& x : th) x.join();
        if (spawned) {
        // stitch: keep only spans that chain exactly onto verified bytes
        out.start = (size_t)start;
        out.batch_bs = gbs;
        Py_ssize_t budget = max_frames;
        size_t verified = (size_t)start;
        for (int t = 0; t < W && budget > 0; t++) {
          SpanAcc& a = accs[t];
          if (a.start != verified || a.nframes == 0 || a.batch_bs != gbs)
            break;
          const Py_ssize_t take =
              (Py_ssize_t)a.nframes < budget ? a.nframes : budget;
          out.pcm.insert(out.pcm.end(), a.pcm.begin(),
                         a.pcm.begin() + (size_t)take * stride);
          out.fend.insert(out.fend.end(), a.fend.begin(),
                          a.fend.begin() + take);
          out.fcrc.insert(out.fcrc.end(), a.fcrc.begin(),
                          a.fcrc.begin() + take);
          out.fmax.insert(out.fmax.end(), a.fmax.begin(),
                          a.fmax.begin() + take);
          out.nframes += (int)take;
          budget -= take;
          verified = out.fend.back();
        }
        out.pos = verified;
        if (budget > 0) {
          // serial finish from the last verified boundary: reproduces every
          // serial stop condition (tail frame, parse error, EOF, budget)
          SpanAcc tail;
          decode_span(data, len, verified, budget, sinfo_depth, channels,
                      len, out.nframes ? gbs : -1, tail);
          out.pcm.insert(out.pcm.end(), tail.pcm.begin(), tail.pcm.end());
          out.fend.insert(out.fend.end(), tail.fend.begin(),
                          tail.fend.end());
          out.fcrc.insert(out.fcrc.end(), tail.fcrc.begin(),
                          tail.fcrc.end());
          out.fmax.insert(out.fmax.end(), tail.fmax.begin(),
                          tail.fmax.end());
          out.nframes += tail.nframes;
          out.pos = tail.pos;
          out.err = tail.err;
          if (out.batch_bs < 0) out.batch_bs = tail.batch_bs;
        }
        done = true;
        }  // if (spawned)
      }
    }
  }
  if (!done)
    decode_span(data, len, (size_t)start, max_frames, sinfo_depth, channels,
                len, -1, out);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  if (out.nframes == 0 && out.err) {
    PyErr_SetString(PyExc_ValueError, out.err);
    return nullptr;
  }
  return span_result(out);
}

static PyMethodDef methods[] = {
    {"crc32_ogg", py_crc32_ogg, METH_VARARGS,
     "Ogg page CRC-32 (0x04C11DB7, non-reflected), slice-by-8"},
    {"parse_frames", py_parse_frames, METH_VARARGS,
     "batch-parse FLAC frames into device-synthesis form"},
    {"decode_frames_pcm_mt", py_decode_frames_pcm_mt, METH_VARARGS,
     "frame-parallel fused flac2wav decode (last arg: thread count); "
     "byte-identical to decode_frames_pcm by construction"},
    {"decode_frames_pcm", py_decode_frames_pcm, METH_VARARGS,
     "fused parse+synthesize+serialize to interleaved WAV-container PCM"},
    {"synthesize", py_synthesize, METH_VARARGS,
     "host IIR synthesis + stereo recombination (all-native decode)"},
    {"assemble_ranges", py_assemble_ranges, METH_VARARGS,
     "tighten a word-aligned frame stream into exact concatenation"},
    {"md5", py_md5, METH_VARARGS, "MD5 digest of a byte buffer"},
    {"md5_init", py_md5_init, METH_NOARGS, "new streaming MD5 context (bytes)"},
    {"md5_update", py_md5_update, METH_VARARGS,
     "md5_update(ctx, data) -> updated ctx"},
    {"md5_final", py_md5_final, METH_VARARGS, "md5_final(ctx) -> 16-byte digest"},
    {"crc16", py_crc16, METH_VARARGS, "CRC-16/UMTS (poly 0x18005, init 0)"},
    {"crc8", py_crc8, METH_VARARGS, "CRC-8/SMBUS (poly 0x07, init 0)"},
    {"deinterleave", py_deinterleave, METH_VARARGS,
     "WAV bytes -> planar int32 (reference WavReader semantics)"},
    {"assemble", py_assemble, METH_VARARGS,
     "concatenate frame slices + CRC footers into one stream"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_zf_native",
                                       "zigflac_tpu native host runtime",
                                       -1, methods};

PyMODINIT_FUNC PyInit__zf_native(void) {
  init_crc_tables();
  init_crc32o();
  return PyModule_Create(&moduledef);
}
