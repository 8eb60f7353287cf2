// Native PCD codec: parallel ASCII number parsing/formatting + PCL-style
// LZF (de)compression for the binary_compressed DATA mode.
//
// Plays the role PCL's C++ IO plays in the reference
// (pcl::io::loadPCDFile / PCDWriter at
// PointCloudProcessor/src/PointCloudProcessor.cpp:112,135,217,542,920):
// the host-side IO hot path. The accelerator does the compute; this library keeps
// dataset load/save off the Python interpreter's critical path (a 2M-point
// ASCII cloud parses ~2 orders of magnitude faster than np.loadtxt).
//
// Pure C ABI; bound from Python with ctypes (pointcloudprocessor_tpu/io/
// native.py), with a numpy fallback when the library is not built.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Fast bounded double parser: [-+]?d*[.d*][eE[-+]?d+]. Returns the value and
// advances *pp past the token. No locale, no allocation.
inline double parse_double(const char** pp, const char* end) {
  const char* p = *pp;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  double val = 0.0;
  while (p < end && *p >= '0' && *p <= '9') val = val * 10.0 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      val += (*p++ - '0') * scale;
      scale *= 0.1;
    }
  }
  // nan/inf tokens (PCL writes "nan" for invalid points).
  if (p < end && (*p == 'n' || *p == 'N' || *p == 'i' || *p == 'I' ||
                  *p == 'a' || *p == 'A')) {
    // Consume the alpha token; x/y/z nan rows are caller-filtered.
    bool is_nan = (*p == 'n' || *p == 'N' || *p == 'a' || *p == 'A');
    while (p < end && (isalpha((unsigned char)*p))) ++p;
    *pp = p;
    return is_nan ? __builtin_nan("") : __builtin_inf() * (neg ? -1.0 : 1.0);
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    int ex = 0;
    while (p < end && *p >= '0' && *p <= '9') ex = ex * 10 + (*p++ - '0');
    double f = 1.0;
    double base = eneg ? 0.1 : 10.0;
    while (ex) {
      if (ex & 1) f *= base;
      base *= base;
      ex >>= 1;
    }
    val *= f;
  }
  *pp = p;
  return neg ? -val : val;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

extern "C" {

// Parse `max_rows` x `ncols` whitespace-separated numbers from buf into out
// (row-major doubles). Rows are newline-delimited. Returns rows parsed.
long pcd_parse_ascii(const char* buf, long len, int ncols, double* out,
                     long max_rows) {
  // Pass 1: newline offsets (row starts).
  std::vector<long> starts;
  starts.reserve((size_t)(len / 16) + 1);
  long pos = 0;
  while (pos < len) {
    // Skip blank lines.
    while (pos < len && (buf[pos] == '\n' || buf[pos] == '\r')) ++pos;
    if (pos >= len) break;
    starts.push_back(pos);
    while (pos < len && buf[pos] != '\n') ++pos;
  }
  long nrows = (long)starts.size();
  if (nrows > max_rows) nrows = max_rows;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long r = 0; r < nrows; ++r) {
    const char* p = buf + starts[r];
    const char* end = buf + len;
    double* row = out + (size_t)r * ncols;
    for (int c = 0; c < ncols; ++c) {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') {
        row[c] = __builtin_nan("");
        continue;
      }
      row[c] = parse_double(&p, end);
    }
  }
  return nrows;
}

// Format nrows x ncols doubles as ASCII ("%.8g" floats / "%ld" ints chosen
// per column by is_int). Returns bytes written, or -(needed) if out_cap is
// too small (caller retries with a larger buffer).
long pcd_format_ascii(const double* data, long nrows, int ncols,
                      const int* is_int, char* out, long out_cap) {
  // Each thread formats a contiguous row range into a private buffer, then
  // ranges are concatenated — deterministic output, parallel formatting.
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<char>> chunks((size_t)nthreads);
  std::vector<long> sizes((size_t)nthreads, 0);
  long rows_per = (nrows + nthreads - 1) / nthreads;

#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
#endif
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    long r0 = (long)t * rows_per;
    long r1 = r0 + rows_per;
    if (r1 > nrows) r1 = nrows;
    if (r0 < r1) {
      std::vector<char>& local = chunks[(size_t)t];
      local.resize((size_t)(r1 - r0) * ncols * 32 + 64);
      char* w = local.data();
      for (long r = r0; r < r1; ++r) {
        const double* row = data + (size_t)r * ncols;
        for (int c = 0; c < ncols; ++c) {
          if (c) *w++ = ' ';
          if (is_int[c]) {
            w += snprintf(w, 32, "%lld", (long long)row[c]);
          } else {
            w += snprintf(w, 32, "%.8g", row[c]);
          }
        }
        *w++ = '\n';
      }
      sizes[(size_t)t] = (long)(w - local.data());
    }
  }

  long total = 0;
  for (int t = 0; t < nthreads; ++t) total += sizes[(size_t)t];
  if (total > out_cap) return -total;
  char* w = out;
  for (int t = 0; t < nthreads; ++t) {
    memcpy(w, chunks[(size_t)t].data(), (size_t)sizes[(size_t)t]);
    w += sizes[(size_t)t];
  }
  return total;
}

// LZF decompression, PCL binary_compressed-compatible (liblzf stream
// format: literal runs (ctrl < 32) and back-references). Returns
// decompressed size, or -1 on malformed input / overflow.
long pcd_lzf_decompress(const unsigned char* in, long in_len,
                        unsigned char* out, long out_len) {
  const unsigned char* ip = in;
  const unsigned char* in_end = in + in_len;
  unsigned char* op = out;
  unsigned char* out_end = out + out_len;
  while (ip < in_end) {
    unsigned int ctrl = *ip++;
    if (ctrl < (1 << 5)) {  // literal run of ctrl+1 bytes
      ++ctrl;
      if (op + ctrl > out_end || ip + ctrl > in_end) return -1;
      memcpy(op, ip, ctrl);
      op += ctrl;
      ip += ctrl;
    } else {  // back reference
      unsigned int len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      const unsigned char* ref = op - ((ctrl & 0x1f) << 8) - 1 - *ip++;
      if (ref < out || op + len + 2 > out_end) return -1;
      len += 2;
      // Byte-wise copy: references may overlap forward.
      while (len--) *op++ = *ref++;
    }
  }
  return (long)(op - out);
}

// LZF compression (liblzf-style greedy hash chain). Output is compatible
// with pcd_lzf_decompress and PCL's lzfDecompress. Returns compressed size,
// or 0 when incompressible within out_cap (caller falls back to binary).
long pcd_lzf_compress(const unsigned char* in, long in_len, unsigned char* out,
                      long out_cap) {
  if (in_len < 4) return 0;
  const int HLOG = 14;
  std::vector<const unsigned char*> htab((size_t)1 << HLOG, in);
  const unsigned char* ip = in;
  const unsigned char* in_end = in + in_len;
  unsigned char* op = out;
  unsigned char* out_end = out + out_cap;

  auto hash = [](const unsigned char* p) {
    unsigned int v = (unsigned int)((p[0] << 16) | (p[1] << 8) | p[2]);
    return ((v >> (3 * 8 - HLOG)) - v * 5) & (((unsigned)1 << HLOG) - 1);
  };

  long lit = 0;
  unsigned char* lit_hdr = op++;  // reserve space for the first literal header
  if (op >= out_end) return 0;

  while (ip + 2 < in_end) {
    unsigned int h = hash(ip);
    const unsigned char* ref = htab[h];
    htab[h] = ip;
    long off = ip - ref - 1;
    if (ref < ip && off < (1 << 13) && ref + 2 < in_end && ref[0] == ip[0] &&
        ref[1] == ip[1] && ref[2] == ip[2]) {
      // Match of at least 3; extend.
      long maxlen = in_end - ip - 2;
      if (maxlen > 264) maxlen = 264;  // 7 + 255 + 2
      long len = 3;
      while (len < maxlen && ref[len] == ip[len]) ++len;
      long enc = len - 2;

      // Close the literal run.
      if (lit) *lit_hdr = (unsigned char)(lit - 1); else --op;  // unused header
      // Emit match.
      if (op + 4 > out_end) return 0;
      if (enc < 7) {
        *op++ = (unsigned char)((off >> 8) | (enc << 5));
      } else {
        *op++ = (unsigned char)((off >> 8) | (7 << 5));
        *op++ = (unsigned char)(enc - 7);
      }
      *op++ = (unsigned char)(off & 0xff);
      ip += len;
      // Start a new literal run.
      lit = 0;
      lit_hdr = op++;
      if (op >= out_end) return 0;
    } else {
      // Literal byte.
      if (op >= out_end) return 0;
      *op++ = *ip++;
      if (++lit == 32) {
        *lit_hdr = 31;
        lit = 0;
        lit_hdr = op++;
        if (op >= out_end) return 0;
      }
    }
  }
  // Trailing literals.
  while (ip < in_end) {
    if (op >= out_end) return 0;
    *op++ = *ip++;
    if (++lit == 32) {
      *lit_hdr = 31;
      lit = 0;
      lit_hdr = op++;
      if (op >= out_end) return 0;
    }
  }
  if (lit) *lit_hdr = (unsigned char)(lit - 1); else --op;
  return (long)(op - out);
}

int pcd_codec_version(void) { return 1; }

}  // extern "C"
