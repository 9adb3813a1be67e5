// Native WordPiece tokenizer of crct_tpu_torch: the hot string path of the
// data pipeline (the port's copy of native/wordpiece.cpp).
//
// The reference's per-sample CPU cost is dominated by BertTokenizer.encode
// calls over chart text (CRCT/fig_dataloader.py:163-230 tokenizes title,
// axis labels, every tick label, legend labels, the question and the
// candidate answers for every example). This C++ implementation provides
// the same BERT-uncased basic tokenization (lowercase, accent folding for
// Latin-1, punctuation splitting, CJK spacing, control/whitespace cleanup)
// and greedy longest-match-first WordPiece, exposed through a C ABI for
// ctypes. It produces identical ids to the Python tokenizer in
// crct_tpu_torch/data/tokenizer.py (tests/test_torch_native.py).
//
// Built by crct_tpu_torch/data/native.py at first use:
//   g++ -O2 -std=c++17 -shared -fPIC -o build/native/libwordpiece-<hash>.so

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 100;
  int max_chars_per_word = 100;
};

// ---- UTF-8 iteration -------------------------------------------------------

inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: treat as single char
}

inline uint32_t utf8_decode(const char* s, int len) {
  const unsigned char* u = reinterpret_cast<const unsigned char*>(s);
  switch (len) {
    case 1: return u[0];
    case 2: return ((u[0] & 0x1F) << 6) | (u[1] & 0x3F);
    case 3: return ((u[0] & 0x0F) << 12) | ((u[1] & 0x3F) << 6) | (u[2] & 0x3F);
    default:
      return ((u[0] & 0x07) << 18) | ((u[1] & 0x3F) << 12) |
             ((u[2] & 0x3F) << 6) | (u[3] & 0x3F);
  }
}

// minimal encode (only needed for BMP chars after lowercasing)
inline void utf8_encode(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---- character classes (BERT basic tokenizer semantics) -------------------

inline bool is_whitespace(uint32_t c) {
  // Python parity: category Zs per _is_whitespace, PLUS U+2028/U+2029 —
  // the pipeline's final str.split() splits on anything str.isspace(),
  // which includes Zl/Zp (verified empirically against the Python path).
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0xA0 ||
         c == 0x1680 || (c >= 0x2000 && c <= 0x200A) || c == 0x202F ||
         c == 0x205F || c == 0x3000 || c == 0x2028 || c == 0x2029;
}

inline bool is_control(uint32_t c) {
  // Python parity (_is_control): category C* except \t \n \r. Covers Cc,
  // the Cf format chars in these blocks, and the Cn gaps of U+2060..206F.
  if (c == '\t' || c == '\n' || c == '\r') return false;
  return c < 0x20 || c == 0x7F || (c >= 0x80 && c <= 0x9F) || c == 0xAD ||
         (c >= 0x200B && c <= 0x200F) || (c >= 0x202A && c <= 0x202E) ||
         (c >= 0x2060 && c <= 0x206F) || c == 0xFEFF;
}

inline bool is_punct(uint32_t c) {
  if ((c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
      (c >= 123 && c <= 126))
    return true;
  // general Unicode punctuation blocks, matching Python's category-P test
  // over the ranges chart text realistically contains. U+2044 (fraction
  // slash) and U+2052 are Sm, not P, so they stay in-word like Python.
  if (c == 0x2044 || c == 0x2052) return false;
  return (c >= 0x2010 && c <= 0x2027) || (c >= 0x2030 && c <= 0x205E) ||
         c == 0xA1 || c == 0xA7 || c == 0xAB || c == 0xB6 || c == 0xB7 ||
         c == 0xBB || c == 0xBF || (c >= 0x3001 && c <= 0x3003) ||
         (c >= 0xFF01 && c <= 0xFF0F) || (c >= 0xFF1A && c <= 0xFF20) ||
         (c >= 0xFF3B && c <= 0xFF40) || (c >= 0xFF5B && c <= 0xFF65);
}

inline bool is_cjk(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0x20000 && c <= 0x2A6DF) || (c >= 0x2A700 && c <= 0x2B73F) ||
         (c >= 0x2B740 && c <= 0x2B81F) || (c >= 0x2B820 && c <= 0x2CEAF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

// Latin-1 / Latin-Extended-A accent folding (NFD strip for the range chart
// text realistically contains). Returns 0 to drop the char.
uint32_t fold_accent(uint32_t c) {
  if (c < 0xC0) return c;
  // exactly the letters Python's NFD _strip_accents reduces: letters WITH a
  // canonical decomposition. Stroke/non-decomposable letters (dj 0x111,
  // hbar 0x127, dotless-i 0x131, kra 0x138, l-mid-dot 0x140, l-stroke
  // 0x142, 'n 0x149, eng 0x14B, t-stroke 0x167, eth 0xF0, thorn 0xFE)
  // stay unchanged there, so they must stay unchanged here too.
  static const struct { uint32_t lo, hi; char base; } kRanges[] = {
      {0xE0, 0xE5, 'a'}, {0xE8, 0xEB, 'e'}, {0xEC, 0xEF, 'i'},
      {0xF2, 0xF6, 'o'}, {0xF9, 0xFC, 'u'}, {0xFD, 0xFD, 'y'},
      {0xFF, 0xFF, 'y'}, {0xE7, 0xE7, 'c'}, {0xF1, 0xF1, 'n'},
      {0x101, 0x105, 'a'}, {0x107, 0x10D, 'c'}, {0x10F, 0x10F, 'd'},
      {0x113, 0x11B, 'e'}, {0x11D, 0x123, 'g'}, {0x125, 0x125, 'h'},
      {0x129, 0x12F, 'i'}, {0x135, 0x135, 'j'}, {0x137, 0x137, 'k'},
      {0x13A, 0x13E, 'l'}, {0x144, 0x148, 'n'}, {0x14D, 0x151, 'o'},
      {0x155, 0x159, 'r'}, {0x15B, 0x161, 's'}, {0x163, 0x165, 't'},
      {0x169, 0x173, 'u'}, {0x175, 0x175, 'w'}, {0x177, 0x177, 'y'},
      {0x17A, 0x17E, 'z'},
  };
  for (const auto& r : kRanges)
    if (c >= r.lo && c <= r.hi) return static_cast<uint32_t>(r.base);
  // combining marks: drop
  if (c >= 0x300 && c <= 0x36F) return 0;
  return c;
}

inline uint32_t to_lower(uint32_t c) {
  // Unicode simple lowercase for ASCII / Latin-1 / Latin Extended-A,
  // matching Python's str.lower(). Ext-A alternates pairing parity:
  // U+0100-0x0137 and U+014A-0x0177 pair even->odd, U+0139-0x0148 and
  // U+0179-0x017E pair odd->even+1; U+0178 (Y-diaeresis) maps to 0xFF.
  // U+0130 maps straight to 'i': Python yields "i"+combining-dot and the
  // accent strip that always follows lowercasing drops the dot.
  if (c >= 'A' && c <= 'Z') return c + 32;
  if (c >= 0xC0 && c <= 0xDE && c != 0xD7) return c + 0x20;  // Latin-1
  if (c == 0x130) return 'i';  // Python: 'i'+combining dot, stripped later
  if ((c >= 0x100 && c <= 0x137) || (c >= 0x14A && c <= 0x177))
    return (c % 2 == 0) ? c + 1 : c;
  if ((c >= 0x139 && c <= 0x148) || (c >= 0x179 && c <= 0x17E))
    return (c % 2 == 1) ? c + 1 : c;
  if (c == 0x178) return 0xFF;
  return c;
}

// basic tokenize: cleanup + lowercase + accents + punct/CJK splitting
std::vector<std::string> basic_tokenize(const std::string& text) {
  std::vector<std::string> words;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      words.push_back(cur);
      cur.clear();
    }
  };
  size_t i = 0;
  while (i < text.size()) {
    int len = utf8_len(static_cast<unsigned char>(text[i]));
    if (i + len > text.size()) len = 1;
    uint32_t c = utf8_decode(text.data() + i, len);
    i += len;
    if (c == 0 || c == 0xFFFD || is_control(c)) continue;
    if (is_whitespace(c)) {
      flush();
      continue;
    }
    c = to_lower(c);
    c = fold_accent(c);
    if (c == 0) continue;
    if (is_punct(c)) {
      flush();
      std::string p;
      utf8_encode(c, &p);
      words.push_back(p);
      continue;
    }
    if (is_cjk(c)) {
      flush();
      std::string p;
      utf8_encode(c, &p);
      words.push_back(p);
      continue;
    }
    utf8_encode(c, &cur);
  }
  flush();
  return words;
}

// greedy longest-match-first wordpiece of one basic token
void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int>* out) {
  // char boundaries
  std::vector<size_t> bounds;
  for (size_t i = 0; i < word.size();) {
    bounds.push_back(i);
    i += utf8_len(static_cast<unsigned char>(word[i]));
  }
  bounds.push_back(word.size());
  if (static_cast<int>(bounds.size()) - 1 > tok.max_chars_per_word) {
    out->push_back(tok.unk_id);
    return;
  }
  std::vector<int> pieces;
  size_t start = 0;
  const size_t n = bounds.size() - 1;
  while (start < n) {
    size_t end = n;
    int found = -1;
    while (start < end) {
      std::string sub = word.substr(bounds[start], bounds[end] - bounds[start]);
      if (start > 0) sub = "##" + sub;
      auto it = tok.vocab.find(sub);
      if (it != tok.vocab.end()) {
        found = it->second;
        break;
      }
      --end;
    }
    if (found < 0) {
      out->push_back(tok.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* tok = new Tokenizer();
  std::string line;
  int idx = 0;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (!line.empty()) tok->vocab.emplace(line, idx);
    ++idx;
  }
  auto it = tok->vocab.find("[UNK]");
  tok->unk_id = it != tok->vocab.end() ? it->second : 100;
  return tok;
}

void wp_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Encode one string; returns the number of ids written (<= max_out).
int wp_encode(void* handle, const char* text, int32_t* out_ids, int max_out) {
  const auto* tok = static_cast<Tokenizer*>(handle);
  std::vector<int> ids;
  for (const auto& w : basic_tokenize(text)) wordpiece(*tok, w, &ids);
  int n = static_cast<int>(ids.size());
  if (n > max_out) n = max_out;
  for (int i = 0; i < n; ++i) out_ids[i] = ids[i];
  return n;
}

// Encode n strings; ids are concatenated into out_ids, with out_offsets
// (n+1 entries) marking each string's span. Returns total ids written.
int wp_encode_batch(void* handle, const char** texts, int n,
                    int32_t* out_ids, int32_t* out_offsets, int max_total) {
  const auto* tok = static_cast<Tokenizer*>(handle);
  int total = 0;
  out_offsets[0] = 0;
  for (int i = 0; i < n; ++i) {
    std::vector<int> ids;
    for (const auto& w : basic_tokenize(texts[i])) wordpiece(*tok, w, &ids);
    for (int id : ids) {
      if (total >= max_total) break;
      out_ids[total++] = id;
    }
    out_offsets[i + 1] = total;
  }
  return total;
}

}  // extern "C"
