// Native swipelog parser — the host-side hot loop of dataset preprocessing.
//
// Parses "How We Swipe" .log text (reference format: dataset/README.md:14-44)
// into flat gesture buffers, matching the Python parser in
// data/parse.py of this package (itself behavior-equivalent to the
// reference data.py:167-231) on the log format's
// ASCII, plain-decimal rows — the three-way parity tests cover this scope.
// Known conservative deltas on pathological input (C++ drops what Python
// keeps, never the reverse): Python's int()/float() underscore separators
// and Unicode digits, str.split() on non-ASCII whitespace, and .lower() on
// non-ASCII words (kept byte-identical here). Semantics:
//   - whitespace-token split, lines with <12 tokens skipped
//   - malformed numeric fields (Python int()/float() failures) skip the line
//   - is_err==1 rows skipped, single-letter words skipped
//   - touchstart/touchmove/touchend state machine; gestures need >=3 points
//   - words lowercased; keyboard dims captured at touchstart
//
// C ABI (ctypes): parse_swipelog() fills a ParseResult of malloc'd buffers;
// free_parse_result() releases them.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tok {
  const char* p;
  size_t n;
};

// Python str.split(): runs of whitespace separate tokens.
static int split_ws(const char* s, const char* end, Tok* toks, int max_toks) {
  int n = 0;
  const char* p = s;
  while (p < end && n < max_toks) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    const char* start = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    toks[n].p = start;
    toks[n].n = static_cast<size_t>(p - start);
    ++n;
  }
  // count any remaining tokens (we only need to know if >= 12)
  while (p < end) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    ++n;
  }
  return n;
}

// Python float(token): strict full-token parse (allows leading/trailing
// nothing beyond the number; inf/nan accepted like Python). strtod would
// also accept hex floats ("0x10") which Python rejects — filter those.
// Deliberate scope limits vs Python (conservative: C++ DROPS rows Python
// would keep, never the reverse, and only on data malformed beyond the
// log format): digit-separator underscores ("1_0"), Unicode digits, and
// numeric tokens longer than 63 chars are rejected.
static bool parse_double(const Tok& t, double* out) {
  if (t.n == 0 || t.n > 63) return false;
  for (size_t i = 0; i < t.n; ++i) {
    if (t.p[i] == 'x' || t.p[i] == 'X') return false;
  }
  char buf[64];
  std::memcpy(buf, t.p, t.n);
  buf[t.n] = '\0';
  char* endp = nullptr;
  double v = std::strtod(buf, &endp);
  if (endp != buf + t.n) return false;
  *out = v;
  return true;
}

// Python int(token): optional sign + digits only.
static bool parse_int(const Tok& t, long long* out) {
  if (t.n == 0 || t.n > 31) return false;
  char buf[32];
  std::memcpy(buf, t.p, t.n);
  buf[t.n] = '\0';
  char* endp = nullptr;
  long long v = std::strtoll(buf, &endp, 10);
  if (endp != buf + t.n) return false;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

struct ParseResult {
  double* points;          // n_points * 3 (x, y, t)
  int64_t* offsets;        // n_gestures + 1 point offsets
  double* kb_dims;         // n_gestures * 2 (width, height)
  char* words;             // concatenated word bytes
  int64_t* word_offsets;   // n_gestures + 1 byte offsets
  int64_t n_gestures;
  int64_t n_points;
};

int parse_swipelog(const char* text, int64_t length, ParseResult* out) {
  std::vector<double> points;
  std::vector<int64_t> offsets{0};
  std::vector<double> kb_dims;
  std::string words;
  std::vector<int64_t> word_offsets{0};

  std::string cur_word;
  std::vector<double> cur_pts;   // x, y, t triples
  double cur_w = 0.0, cur_h = 0.0;

  const char* p = text;
  const char* end = text + length;
  bool first_line = true;        // header skipped (reference data.py:183)

  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;

    if (first_line) {
      first_line = false;
    } else {
      Tok toks[12];
      int ntok = split_ws(p, line_end, toks, 12);
      if (ntok >= 12) {
        long long is_err, ts;
        double x, y, kw, kh;
        const Tok& event = toks[4];
        const Tok& word = toks[10];
        // Word length in CHARACTERS, not bytes: Python's len() counts code
        // points, so a single multibyte character (e.g. 'é') must be
        // dropped here too. UTF-8 continuation bytes have the top two bits
        // 10; counting only non-continuation bytes gives the code-point
        // count.
        size_t word_chars = 0;
        for (size_t wi = 0; wi < word.n; ++wi)
          if ((static_cast<unsigned char>(word.p[wi]) & 0xC0) != 0x80) ++word_chars;
        // Mirror the Python try-block ordering: any field failure skips.
        if (parse_int(toks[11], &is_err) && is_err != 1 && word_chars > 1 &&
            parse_double(toks[5], &x) && parse_double(toks[6], &y) &&
            parse_int(toks[1], &ts)) {
          auto is = [&](const char* s) {
            size_t n = std::strlen(s);
            return event.n == n && std::memcmp(event.p, s, n) == 0;
          };
          // The reference parses keyb_width/height on EVERY event row while
          // building the point dict — a malformed value aborts the line
          // (after current_word was already set on touchstart).
          bool kb_ok = parse_double(toks[2], &kw) && parse_double(toks[3], &kh);
          if (is("touchstart")) {
            cur_word.assign(word.p, word.n);
            for (auto& c : cur_word) c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
            if (kb_ok) {
              cur_w = kw;
              cur_h = kh;
              cur_pts.clear();
              cur_pts.push_back(x);
              cur_pts.push_back(y);
              cur_pts.push_back(static_cast<double>(ts));
            }
          } else if (is("touchmove")) {
            if (!cur_word.empty() && kb_ok) {
              cur_pts.push_back(x);
              cur_pts.push_back(y);
              cur_pts.push_back(static_cast<double>(ts));
            }
          } else if (is("touchend")) {
            if (!cur_word.empty() && !cur_pts.empty() && kb_ok) {
              cur_pts.push_back(x);
              cur_pts.push_back(y);
              cur_pts.push_back(static_cast<double>(ts));
              if (cur_pts.size() / 3 >= 3) {
                points.insert(points.end(), cur_pts.begin(), cur_pts.end());
                offsets.push_back(static_cast<int64_t>(points.size() / 3));
                kb_dims.push_back(cur_w);
                kb_dims.push_back(cur_h);
                words += cur_word;
                word_offsets.push_back(static_cast<int64_t>(words.size()));
              }
              cur_word.clear();
              cur_pts.clear();
            }
          }
        }
      }
    }

    if (!nl) break;
    p = nl + 1;
  }

  auto copy_out = [](auto& vec, auto*& dst) {
    using T = typename std::remove_reference<decltype(vec)>::type::value_type;
    dst = static_cast<T*>(std::malloc(sizeof(T) * (vec.size() ? vec.size() : 1)));
    if (!dst) return false;
    std::memcpy(dst, vec.data(), sizeof(T) * vec.size());
    return true;
  };

  out->n_gestures = static_cast<int64_t>(offsets.size() - 1);
  out->n_points = static_cast<int64_t>(points.size() / 3);
  if (!copy_out(points, out->points)) return 1;
  if (!copy_out(offsets, out->offsets)) return 1;
  if (!copy_out(kb_dims, out->kb_dims)) return 1;
  if (!copy_out(word_offsets, out->word_offsets)) return 1;
  out->words = static_cast<char*>(std::malloc(words.size() ? words.size() : 1));
  if (!out->words) return 1;
  std::memcpy(out->words, words.data(), words.size());
  return 0;
}

void free_parse_result(ParseResult* r) {
  std::free(r->points);
  std::free(r->offsets);
  std::free(r->kb_dims);
  std::free(r->words);
  std::free(r->word_offsets);
  r->points = nullptr;
  r->offsets = nullptr;
  r->kb_dims = nullptr;
  r->words = nullptr;
  r->word_offsets = nullptr;
}

}  // extern "C"
