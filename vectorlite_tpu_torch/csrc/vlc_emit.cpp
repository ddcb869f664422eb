// Native .vlc JSON codec: array emitter (serde_json::to_string_pretty
// parity) + bulk-array parser (vlc_parse_doc, at the bottom).
//
// The port's copy of the JAX package's native .vlc codec, built with
// g++ by kernels/_build.py. The Python emitter in persist/vlc.py renders
// every float through a pure-Python ryu-style formatter (~3.6 us/value);
// a 100Kx384 snapshot took 137 s. Here std::to_chars supplies the shortest round-trip
// digits (the same digits ryu produces) and the rendering rule below is
// the exact rule `_emit_f64` implements — ryu's `Buffer::format`
// (pretty d2s), the formatter serde_json::to_string_pretty uses
// (reference: src/persistence.rs:137):
//
//   value = 0.D1D2...Dn x 10^kk, D1 != 0
//   decimal notation while kk in (-5, 16]; otherwise scientific with a
//   bare exponent (`1e308`, `5e-324`) and no trailing `.0` mantissa.
//   Integral decimals end in `.0`; zero prints `0.0` / `-0.0`;
//   non-finite serializes as null (serde_json behavior).
//
// tests/test_torch_persist.py asserts byte equality of native-on and
// native-off snapshots, and against the JAX package's own saves.
//
// Element mode: each value is rendered as `<pad><text>,\n` (the last
// element of the array drops the comma when last_no_comma is set), so
// Python can stream arbitrarily large arrays through bounded chunks and
// own the surrounding `[\n` / `<pad>]` brackets.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>

namespace {

// Render one finite double per the rule above. Returns bytes written.
inline int fmt_f64(double x, char* out) {
  if (std::isnan(x) || std::isinf(x)) {
    std::memcpy(out, "null", 4);
    return 4;
  }
  char* p = out;
  if (std::signbit(x)) {
    *p++ = '-';
    x = -x;
  }
  if (x == 0.0) {
    std::memcpy(p, "0.0", 3);
    return int(p - out) + 3;
  }
  // shortest round-trip digits in scientific form: d[.frac]e[+-]dd
  char sci[40];
  auto res = std::to_chars(sci, sci + sizeof(sci), x,
                           std::chars_format::scientific);
  // parse mantissa digits and exponent
  char digits[24];
  int ndig = 0;
  int exp10 = 0;
  {
    const char* q = sci;
    digits[ndig++] = *q++;  // leading digit (never '0' for x > 0)
    if (*q == '.') {
      ++q;
      while (*q != 'e') digits[ndig++] = *q++;
    }
    ++q;  // 'e'
    bool neg = false;
    if (*q == '+' || *q == '-') neg = (*q++ == '-');
    while (q < res.ptr) exp10 = exp10 * 10 + (*q++ - '0');
    if (neg) exp10 = -exp10;
  }
  // shortest form has no trailing zeros, but be safe (keeps >= 1 digit)
  while (ndig > 1 && digits[ndig - 1] == '0') --ndig;
  const int kk = exp10 + 1;  // value = 0.digits x 10^kk
  if (0 < kk && kk <= 16) {
    if (ndig <= kk) {  // integer-valued: pad with zeros, add .0
      std::memcpy(p, digits, ndig);
      p += ndig;
      for (int i = ndig; i < kk; ++i) *p++ = '0';
      *p++ = '.';
      *p++ = '0';
    } else {
      std::memcpy(p, digits, kk);
      p += kk;
      *p++ = '.';
      std::memcpy(p, digits + kk, ndig - kk);
      p += ndig - kk;
    }
  } else if (-5 < kk && kk <= 0) {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -kk; ++i) *p++ = '0';
    std::memcpy(p, digits, ndig);
    p += ndig;
  } else {  // scientific: D1[.rest]e<kk-1>
    *p++ = digits[0];
    if (ndig > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, ndig - 1);
      p += ndig - 1;
    }
    *p++ = 'e';
    int e = kk - 1;
    if (e < 0) {
      *p++ = '-';
      e = -e;
    }
    char eb[8];
    int ne = 0;
    do {
      eb[ne++] = char('0' + e % 10);
      e /= 10;
    } while (e);
    while (ne) *p++ = eb[--ne];
  }
  return int(p - out);
}

inline int fmt_u64(uint64_t u, char* out) {
  char b[24];
  int n = 0;
  do {
    b[n++] = char('0' + u % 10);
    u /= 10;
  } while (u);
  char* p = out;
  while (n) *p++ = b[--n];
  return int(p - out);
}

// serde_json-compatible string escape (the rule _emit_str implements):
// named escapes for " \ \n \r \t \b \f, \u00xx for other control bytes,
// raw UTF-8 passthrough for everything else. Returns bytes written
// (worst case 6x the input).
inline int64_t esc_str(const char* s, int64_t n, char* out) {
  static const char hex[] = "0123456789abcdef";
  char* p = out;
  *p++ = '"';
  for (int64_t i = 0; i < n; ++i) {
    unsigned char ch = (unsigned char)s[i];
    switch (ch) {
      case '"': *p++ = '\\'; *p++ = '"'; break;
      case '\\': *p++ = '\\'; *p++ = '\\'; break;
      case '\n': *p++ = '\\'; *p++ = 'n'; break;
      case '\r': *p++ = '\\'; *p++ = 'r'; break;
      case '\t': *p++ = '\\'; *p++ = 't'; break;
      case '\b': *p++ = '\\'; *p++ = 'b'; break;
      case '\f': *p++ = '\\'; *p++ = 'f'; break;
      default:
        if (ch < 0x20) {
          *p++ = '\\'; *p++ = 'u'; *p++ = '0'; *p++ = '0';
          *p++ = hex[ch >> 4]; *p++ = hex[ch & 0xf];
        } else {
          *p++ = char(ch);
        }
    }
  }
  *p++ = '"';
  return p - out;
}

// Emit one f64 array in full ([\n elems ]\n-less) at array_indent: the
// opening bracket is written by the caller-context (we render
// "[\n<elems>\n<pad>]"). Returns bytes written.
inline char* emit_f64_array(const double* vals, int64_t n, int pad_elem,
                            const char* padbuf, int pad_close, char* p) {
  if (n == 0) {
    *p++ = '[';
    *p++ = ']';
    return p;
  }
  *p++ = '[';
  *p++ = '\n';
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, padbuf, pad_elem);
    p += pad_elem;
    p += fmt_f64(vals[i], p);
    if (i + 1 < n) *p++ = ',';
    *p++ = '\n';
  }
  std::memcpy(p, padbuf, pad_close);
  p += pad_close;
  *p++ = ']';
  return p;
}

inline int fmt_i64(int64_t v, char* out) {
  char* p = out;
  uint64_t u;
  if (v < 0) {
    *p++ = '-';
    u = uint64_t(~v) + 1;  // safe for INT64_MIN
  } else {
    u = uint64_t(v);
  }
  char b[24];
  int n = 0;
  do {
    b[n++] = char('0' + u % 10);
    u /= 10;
  } while (u);
  while (n) *p++ = b[--n];
  return int(p - out);
}

}  // namespace

extern "C" {

// Single-value formatter (exposed for the parity test).
int32_t vlc_fmt_f64(double x, char* out) { return fmt_f64(x, out); }

// Emit n values in element mode at `indent` (2 spaces per level). When
// last_no_comma != 0 the final element omits its comma (it is the last
// element of the JSON array). Returns bytes written, or -1 if out_cap
// could be exceeded (caller sizes via worst case: pad + 24 + 2 bytes
// per element).
int64_t vlc_emit_f64_elems(const double* vals, int64_t n, int32_t indent,
                           int32_t last_no_comma, char* out,
                           int64_t out_cap) {
  const int pad = 2 * indent;
  if (pad > 512) return -1;
  if ((pad + 26) * n > out_cap) return -1;
  char padbuf[512];
  std::memset(padbuf, ' ', pad);
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, padbuf, pad);
    p += pad;
    p += fmt_f64(vals[i], p);
    if (i + 1 < n || !last_no_comma) *p++ = ',';
    *p++ = '\n';
  }
  return p - out;
}

int64_t vlc_emit_i64_elems(const int64_t* vals, int64_t n, int32_t indent,
                           int32_t last_no_comma, char* out,
                           int64_t out_cap) {
  const int pad = 2 * indent;
  if (pad > 512) return -1;
  if ((pad + 23) * n > out_cap) return -1;
  char padbuf[512];
  std::memset(padbuf, ' ', pad);
  char* p = out;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(p, padbuf, pad);
    p += pad;
    p += fmt_i64(vals[i], p);
    if (i + 1 < n || !last_no_comma) *p++ = ',';
    *p++ = '\n';
  }
  return p - out;
}

// Bulk Flat-row emitter: renders n_rows `Vector` dicts of the `data`
// array (reference serde shape: src/lib.rs:163-174) in one call —
//
//   <pad_ei>{
//   <pad_k>"id": <u64>,
//   <pad_k>"values": [ ...d floats, elements at pad_v... ],
//   <pad_k>"text": "<escaped>",
//   <pad_k>"metadata": <verbatim fragment>
//   <pad_ei>},          (last row of the array drops the comma)
//
// with elem_indent the indent level of the row dicts. `texts` holds the
// raw UTF-8 of all texts back to back (offsets text_offs[0..n]),
// escaped here; `metas` holds PRE-RENDERED JSON fragments (offsets
// meta_offs[0..n]) spliced verbatim — arbitrary metadata stays exact
// because Python renders it. Returns bytes written or -1 if out_cap
// could be exceeded (checked per row before writing).
int64_t vlc_emit_rows(const uint64_t* ids, const double* vals,
                      int64_t n_rows, int64_t d, const char* texts,
                      const int64_t* text_offs, const char* metas,
                      const int64_t* meta_offs, int32_t elem_indent,
                      int32_t last_no_comma, char* out, int64_t out_cap) {
  const int pad_ei = 2 * elem_indent;
  const int pad_k = pad_ei + 2;
  const int pad_v = pad_k + 2;
  if (pad_v > 510) return -1;
  char padbuf[512];
  std::memset(padbuf, ' ', sizeof(padbuf));
  char* p = out;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t tlen = text_offs[r + 1] - text_offs[r];
    const int64_t mlen = meta_offs[r + 1] - meta_offs[r];
    // conservative row bound: fixed skeleton + values + escaped text
    const int64_t need = 6 * pad_v + 96 + d * (pad_v + 26) + 6 * tlen + mlen;
    if ((p - out) + need > out_cap) return -1;
    std::memcpy(p, padbuf, pad_ei); p += pad_ei;
    *p++ = '{'; *p++ = '\n';
    std::memcpy(p, padbuf, pad_k); p += pad_k;
    std::memcpy(p, "\"id\": ", 6); p += 6;
    p += fmt_u64(ids[r], p);
    *p++ = ','; *p++ = '\n';
    std::memcpy(p, padbuf, pad_k); p += pad_k;
    std::memcpy(p, "\"values\": ", 10); p += 10;
    p = emit_f64_array(vals + r * d, d, pad_v, padbuf, pad_k, p);
    *p++ = ','; *p++ = '\n';
    std::memcpy(p, padbuf, pad_k); p += pad_k;
    std::memcpy(p, "\"text\": ", 8); p += 8;
    p += esc_str(texts + text_offs[r], tlen, p);
    *p++ = ','; *p++ = '\n';
    std::memcpy(p, padbuf, pad_k); p += pad_k;
    std::memcpy(p, "\"metadata\": ", 12); p += 12;
    std::memcpy(p, metas + meta_offs[r], mlen); p += mlen;
    *p++ = '\n';
    std::memcpy(p, padbuf, pad_ei); p += pad_ei;
    *p++ = '}';
    if (r + 1 < n_rows || !last_no_comma) *p++ = ',';
    *p++ = '\n';
  }
  return p - out;
}

// Bulk keyed-array emitter: renders n dict entries `"<key>": [floats]`
// (the HNSW `vector_values` map, reference: src/index/hnsw.rs:197-213)
// at elem_indent. Keys are raw UTF-8 (escaped here); per-entry array
// lengths come from `lens` with values concatenated in `vals`.
int64_t vlc_emit_keyed_arrays(const char* keys, const int64_t* key_offs,
                              const double* vals, const int64_t* lens,
                              int64_t n, int32_t elem_indent,
                              int32_t last_no_comma, char* out,
                              int64_t out_cap) {
  const int pad_ei = 2 * elem_indent;
  const int pad_v = pad_ei + 2;
  if (pad_v > 510) return -1;
  char padbuf[512];
  std::memset(padbuf, ' ', sizeof(padbuf));
  char* p = out;
  int64_t voff = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t klen = key_offs[r + 1] - key_offs[r];
    const int64_t dn = lens[r];
    const int64_t need = 2 * pad_v + 32 + dn * (pad_v + 26) + 6 * klen;
    if ((p - out) + need > out_cap) return -1;
    std::memcpy(p, padbuf, pad_ei); p += pad_ei;
    p += esc_str(keys + key_offs[r], klen, p);
    *p++ = ':'; *p++ = ' ';
    p = emit_f64_array(vals + voff, dn, pad_v, padbuf, pad_ei, p);
    voff += dn;
    if (r + 1 < n || !last_no_comma) *p++ = ',';
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------- parser
//
// json.loads on a numeric-heavy snapshot is the load bottleneck (2.8 s
// of a 4.0 s load at 20Kx384; a 1Mx384 document is ~10 GB of text and
// its Python object tree does not fit in RAM at all). vlc_parse_doc
// walks the document once, parses the KNOWN bulk arrays straight into
// f64/i64 buffers, and splices a `["<nonce>:<idx>"]` sentinel into a
// skeleton copy that Python then json.loads (small) and re-inserts
// ndarrays into. Only path-exact arrays are extracted, so arbitrary
// user metadata is byte-preserved and parsed by Python:
//
//   $.index.Flat.data[*].values
//   $.index.HNSW.vector_values.*
//   $.index.HNSW.graph.{adj0,levels}
//   $.index.HNSW.graph.upper[*]
//
// An eligible array containing anything but finite int/float tokens
// (e.g. the `null` that serde writes for non-finite f64) is left
// in place verbatim — Python sees exactly what json.loads would.

namespace {

// lookup table: bytes that can appear in a JSON number token
struct NumChars {
  bool t[256] = {};
  constexpr NumChars() {
    for (char c : {'+', '-', '.', 'e', 'E', '0', '1', '2', '3', '4',
                   '5', '6', '7', '8', '9'})
      t[(unsigned char)c] = true;
  }
};
constexpr NumChars kNum;

struct Parser {
  const char* p;
  const char* end;
  const char* last_copied;  // doc tail not yet copied to skel
  char* skel;
  int64_t sn, scap;
  double* dv;
  int64_t dn, dcap;
  int64_t* iv;
  int64_t in_, icap;
  int64_t* lens;  // per extracted array: +len = f64, -len = i64
  int64_t an, acap;
  const char* nonce;
  int64_t nonce_len;
  // path stack: object keys / "\x01" for array elements
  const char* pk[64];
  int64_t pkl[64];
  int depth = 0;
  int err = 0;  // 1 = overflow, 2 = malformed

  void ws() {
    while (p < end &&
           (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
  }

  bool seg(int i, const char* s) const {
    int64_t n = int64_t(std::strlen(s));
    return pkl[i] == n && std::memcmp(pk[i], s, n) == 0;
  }

  bool eligible() const {
    if (depth == 5 && seg(0, "index") && seg(1, "Flat") &&
        seg(2, "data") && pkl[3] == 1 && pk[3][0] == '\x01' &&
        seg(4, "values"))
      return true;
    if (depth == 4 && seg(0, "index") && seg(1, "HNSW") &&
        seg(2, "vector_values"))
      return true;
    if (depth == 4 && seg(0, "index") && seg(1, "HNSW") &&
        seg(2, "graph") && (seg(3, "adj0") || seg(3, "levels")))
      return true;
    if (depth == 5 && seg(0, "index") && seg(1, "HNSW") &&
        seg(2, "graph") && seg(3, "upper") && pkl[4] == 1 &&
        pk[4][0] == '\x01')
      return true;
    return false;
  }

  void skip_string() {
    // at opening quote
    ++p;
    while (p < end) {
      char c = *p++;
      if (c == '\\') {
        if (p < end) ++p;
      } else if (c == '"') {
        return;
      }
    }
    err = 2;
  }

  void skip_number() {
    while (p < end && kNum.t[(unsigned char)*p]) ++p;
  }

  // Try to parse a flat numeric array starting at '['. On success the
  // values are committed to dv/iv, the lens entry recorded, the
  // sentinel written, and true returned with p past the ']'.
  bool try_numeric_array() {
    const char* start = p;  // at '['
    const char* q = p + 1;
    int64_t sd = dn, si = in_;
    bool is_float = false;
    while (true) {
      while (q < end &&
             (*q == ' ' || *q == '\n' || *q == '\t' || *q == '\r' ||
              *q == ','))
        ++q;
      if (q >= end) return false;
      if (*q == ']') break;
      const char* t0 = q;
      while (q < end && kNum.t[(unsigned char)*q]) ++q;
      if (q == t0) return false;  // null / string / nested -> bail
      double d;
      auto r = std::from_chars(t0, q, d);
      if (r.ec != std::errc() || r.ptr != q) return false;
      if (dn >= dcap) {
        err = 1;
        return false;
      }
      dv[dn++] = d;
      if (!is_float) {
        bool intish = true;
        for (const char* c = t0; c < q; ++c)
          if (*c == '.' || *c == 'e' || *c == 'E') {
            intish = false;
            break;
          }
        int64_t v = 0;
        if (intish) {
          auto ri = std::from_chars(t0, q, v);
          intish = (ri.ec == std::errc() && ri.ptr == q);
        }
        if (intish) {
          if (in_ >= icap) {
            err = 1;
            return false;
          }
          iv[in_++] = v;
        } else {
          is_float = true;
          in_ = si;  // discard the int interpretation
        }
      }
    }
    ++q;  // past ']'
    if (an >= acap) {
      err = 1;
      return false;
    }
    int64_t len = dn - sd;
    if (is_float || len == 0) {
      in_ = si;
      lens[an] = len;
    } else {
      dn = sd;  // all-int: keep the i64 interpretation
      lens[an] = -len;
    }
    // copy doc[last_copied..start) then the sentinel
    int64_t pre = start - last_copied;
    char idxbuf[24];
    int ni = 0;
    {
      int64_t a = an;
      char tmp[24];
      int m = 0;
      do {
        tmp[m++] = char('0' + a % 10);
        a /= 10;
      } while (a);
      while (m) idxbuf[ni++] = tmp[--m];
    }
    int64_t need = pre + 2 + nonce_len + 1 + ni + 2;
    if (sn + need > scap) {
      err = 1;
      return false;
    }
    std::memcpy(skel + sn, last_copied, pre);
    sn += pre;
    skel[sn++] = '[';
    skel[sn++] = '"';
    std::memcpy(skel + sn, nonce, nonce_len);
    sn += nonce_len;
    skel[sn++] = ':';
    std::memcpy(skel + sn, idxbuf, ni);
    sn += ni;
    skel[sn++] = '"';
    skel[sn++] = ']';
    last_copied = q;
    ++an;
    p = q;
    return true;
  }

  void parse_array() {
    ++p;  // '['
    if (depth < 64) {
      pk[depth] = "\x01";
      pkl[depth] = 1;
    }
    ++depth;
    ws();
    if (p < end && *p == ']') {
      ++p;
      --depth;
      return;
    }
    while (p < end && !err) {
      parse_value();
      ws();
      if (p < end && *p == ',') {
        ++p;
        ws();
        continue;
      }
      if (p < end && *p == ']') {
        ++p;
        --depth;
        return;
      }
      break;
    }
    if (!err) err = 2;
  }

  void parse_object() {
    ++p;  // '{'
    ws();
    if (p < end && *p == '}') {
      ++p;
      return;
    }
    while (p < end && !err) {
      ws();
      if (p >= end || *p != '"') {
        err = 2;
        return;
      }
      const char* k0 = p + 1;
      skip_string();
      if (err) return;
      const char* k1 = p - 1;
      ws();
      if (p >= end || *p != ':') {
        err = 2;
        return;
      }
      ++p;
      if (depth < 64) {
        pk[depth] = k0;
        pkl[depth] = k1 - k0;
      }
      ++depth;
      parse_value();
      --depth;
      if (err) return;
      ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      if (p < end && *p == '}') {
        ++p;
        return;
      }
      err = 2;
      return;
    }
    if (!err) err = 2;
  }

  void parse_value() {
    // Depth cap: the mutual parse_value/parse_array/parse_object
    // recursion otherwise overflows the C++ stack (SIGSEGV, killing
    // the process) on pathologically nested input (~100K+ brackets).
    // Legit .vlc documents are depth <= 6; beyond the cap we report
    // "malformed" (err=2) so the caller falls back to json.loads,
    // whose RecursionError the Python layer converts to the canonical
    // SerializationError.
    if (depth > 1000) {
      err = 2;
      return;
    }
    ws();
    if (p >= end) {
      err = 2;
      return;
    }
    char c = *p;
    if (c == '"') {
      skip_string();
    } else if (c == '{') {
      parse_object();
    } else if (c == '[') {
      if (depth <= 64 && eligible()) {
        int64_t sd = dn, si = in_;
        if (try_numeric_array()) return;
        if (err) return;
        dn = sd;
        in_ = si;  // roll back a failed attempt
      }
      parse_array();
    } else if (c == 't') {
      p += 4;
    } else if (c == 'f') {
      p += 5;
    } else if (c == 'n') {
      p += 4;
    } else {
      skip_number();
    }
    if (p > end) err = 2;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 on buffer overflow (retry with bigger
// buffers), 2 on malformed input (caller falls back to json.loads).
// out_counts[4] = {skeleton_len, num_arrays, num_f64, num_i64}.
int32_t vlc_parse_doc(const char* doc, int64_t len, const char* nonce,
                      char* skel, int64_t skel_cap, double* dvals,
                      int64_t dcap, int64_t* ivals, int64_t icap,
                      int64_t* lens, int64_t lens_cap,
                      int64_t* out_counts) {
  Parser ps;
  ps.p = doc;
  ps.end = doc + len;
  ps.last_copied = doc;
  ps.skel = skel;
  ps.sn = 0;
  ps.scap = skel_cap;
  ps.dv = dvals;
  ps.dn = 0;
  ps.dcap = dcap;
  ps.iv = ivals;
  ps.in_ = 0;
  ps.icap = icap;
  ps.lens = lens;
  ps.an = 0;
  ps.acap = lens_cap;
  ps.nonce = nonce;
  ps.nonce_len = int64_t(std::strlen(nonce));
  ps.parse_value();
  if (!ps.err) {
    ps.ws();
    if (ps.p != ps.end) ps.err = 2;
  }
  if (ps.err) return ps.err;
  int64_t tail = ps.end - ps.last_copied;
  if (ps.sn + tail > ps.scap) return 1;
  std::memcpy(ps.skel + ps.sn, ps.last_copied, tail);
  ps.sn += tail;
  out_counts[0] = ps.sn;
  out_counts[1] = ps.an;
  out_counts[2] = ps.dn;
  out_counts[3] = ps.in_;
  return 0;
}

}  // extern "C"
