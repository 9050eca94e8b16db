// MVLT-TPU native host-side kernels.
//
// The reference leans on two third-party native layers for host
// preprocessing throughput: the HF fast tokenizer (Rust) for WordPiece
// (mcloader/fashion_gen.py:46) and PIL/cv2 C cores for image decode/crop/
// resize (mcloader/fashion_gen.py:108-112, 411-428).  This library is the
// framework's own native equivalent (SURVEY.md §2b): a batch WordPiece
// tokenizer and a fused whitespace-crop + bilinear-resize image kernel,
// exposed through a minimal C ABI consumed via ctypes
// (mvlt_tpu/data/native.py).  Python implementations remain the semantic
// ground truth; parity is asserted in tests/test_native.py.
//
// Build: native/build.sh  (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// WordPiece tokenizer (BERT-uncased semantics, ASCII + Latin-1 fast path)
// ---------------------------------------------------------------------------

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 100, cls_id = 101, sep_id = 102, pad_id = 0, mask_id = 103;
  int32_t max_chars_per_word = 200;
};

// Latin-1 lowercase + accent strip table for codepoints 0xC0..0xFF.
// NFD accent stripping of these characters yields the base ASCII letter
// (matching Python's unicodedata.normalize('NFD') + Mn-removal).
const char* latin1_base(uint32_t cp) {
  switch (cp) {
    case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5:
    case 0xE0: case 0xE1: case 0xE2: case 0xE3: case 0xE5: return "a";
    case 0xC4: case 0xE4: return "a";
    case 0xC7: case 0xE7: return "c";
    case 0xC8: case 0xC9: case 0xCA: case 0xCB:
    case 0xE8: case 0xE9: case 0xEA: case 0xEB: return "e";
    case 0xCC: case 0xCD: case 0xCE: case 0xCF:
    case 0xEC: case 0xED: case 0xEE: case 0xEF: return "i";
    case 0xD1: case 0xF1: return "n";
    case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
    case 0xF2: case 0xF3: case 0xF4: case 0xF5: case 0xF6: return "o";
    case 0xD9: case 0xDA: case 0xDB: case 0xDC:
    case 0xF9: case 0xFA: case 0xFB: case 0xFC: return "u";
    case 0xDD: case 0xFD: case 0xFF: return "y";
    default: return nullptr;  // unsupported: caller falls back to Python
  }
}

bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Decode one UTF-8 codepoint; returns bytes consumed (0 on error).
int utf8_decode(const unsigned char* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  if (s[0] < 0x80) { *cp = s[0]; return 1; }
  if ((s[0] >> 5) == 0x6 && len >= 2) {
    *cp = ((s[0] & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((s[0] >> 4) == 0xE && len >= 3) {
    *cp = ((s[0] & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((s[0] >> 3) == 0x1E && len >= 4) {
    *cp = ((s[0] & 0x07) << 18) | ((s[1] & 0x3F) << 12) |
          ((s[2] & 0x3F) << 6) | (s[3] & 0x3F);
    return 4;
  }
  return 0;
}

// Basic-tokenize: clean, lowercase, strip accents, split on
// whitespace/punctuation.  Returns false if the text contains codepoints
// outside the supported set (caller should fall back to Python).
bool basic_tokenize(const std::string& text, std::vector<std::string>* words) {
  std::string current;
  auto flush = [&]() {
    if (!current.empty()) {
      words->push_back(current);
      current.clear();
    }
  };
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text.data());
  size_t n = text.size(), i = 0;
  while (i < n) {
    uint32_t cp;
    int used = utf8_decode(s + i, n - i, &cp);
    if (used == 0) return false;
    i += used;
    if (cp == 0 || cp == 0xFFFD) continue;
    if (cp < 0x80) {
      unsigned char c = static_cast<unsigned char>(cp);
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
        flush();
      } else if (c < 0x20 || c == 0x7F) {
        continue;  // control chars dropped
      } else if (is_ascii_punct(c)) {
        flush();
        words->push_back(std::string(1, static_cast<char>(c)));
      } else {
        current.push_back(static_cast<char>(std::tolower(c)));
      }
    } else if (cp == 0xA0) {  // NBSP is whitespace (Zs)
      flush();
    } else if (cp >= 0xC0 && cp <= 0xFF) {
      const char* base = latin1_base(cp);
      if (base == nullptr) {
        // 0xD7 (×) and 0xF7 (÷) are Sm punctuation-ish but unicodedata
        // category Sm — BERT does not split on them; unsupported -> fallback
        return false;
      }
      current.append(base);
    } else if ((cp >= 0x2010 && cp <= 0x2027) || cp == 0x2212) {
      // general punctuation range (Pd/Po): split like punctuation.
      // These are multi-byte in UTF-8; emit as-is tokens.
      flush();
      size_t start = i - used;
      words->push_back(text.substr(start, used));
    } else {
      return false;  // CJK, emoji, other scripts: Python fallback
    }
  }
  flush();
  return true;
}

void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int32_t>* ids) {
  if (static_cast<int32_t>(word.size()) > tok.max_chars_per_word) {
    ids->push_back(tok.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0, n = word.size();
  while (start < n) {
    size_t end = n;
    int32_t piece = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = tok.vocab.find(sub);
      if (it != tok.vocab.end()) {
        piece = it->second;
        break;
      }
      --end;
    }
    if (piece < 0) {
      ids->push_back(tok.unk_id);
      return;
    }
    pieces.push_back(piece);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

// ---------------------------------------------------------------------------
// Image kernel: luma-threshold bbox crop + triangle-filter resize
// ---------------------------------------------------------------------------

// PIL 'L' conversion: L = (R*299 + G*587 + B*114) / 1000
inline int luma(const uint8_t* px) {
  return (px[0] * 299 + px[1] * 587 + px[2] * 114) / 1000;
}

struct Contrib {
  int lo, count;
  std::vector<double> w;
};

// PIL-style triangle (bilinear) resampling contributions with antialias
// support scaling on downscale (ImagingResampleHorizontal semantics).
std::vector<Contrib> build_contribs(int in_size, int out_size) {
  std::vector<Contrib> cs(out_size);
  double scale = static_cast<double>(in_size) / out_size;
  double support = scale < 1.0 ? 1.0 : scale;  // filter support * max(1,scale)
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int lo = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int hi = static_cast<int>(std::min(static_cast<double>(in_size),
                                       std::ceil(center + support)));
    Contrib c;
    c.lo = lo;
    c.count = hi - lo;
    c.w.resize(c.count);
    double total = 0.0;
    double inv = scale < 1.0 ? 1.0 : 1.0 / scale;
    for (int k = 0; k < c.count; ++k) {
      double x = (lo + k + 0.5 - center) * inv;
      double wv = x < 0 ? x + 1.0 : 1.0 - x;  // triangle filter
      if (wv < 0) wv = 0;
      c.w[k] = wv;
      total += wv;
    }
    if (total > 0)
      for (auto& wv : c.w) wv /= total;
    cs[xx] = std::move(c);
  }
  return cs;
}

}  // namespace

extern "C" {

// --- tokenizer -------------------------------------------------------------

void* mvlt_tokenizer_create(const char* vocab_path) {
  auto* tok = new Tokenizer();
  std::ifstream f(vocab_path);
  if (!f) {
    delete tok;
    return nullptr;
  }
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty()) tok->vocab.emplace(line, idx);
    ++idx;
  }
  return tok;
}

void mvlt_tokenizer_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Tokenize one text into bare ids (no CLS/SEP).  Returns the number of ids
// written (capped at out_capacity — callers truncate below that anyway), or
// -1 if the text needs the Python fallback (unsupported codepoints).
int32_t mvlt_tokenize(void* handle, const char* text, int32_t* out,
                      int32_t out_capacity) {
  auto* tok = static_cast<Tokenizer*>(handle);
  std::vector<std::string> words;
  if (!basic_tokenize(std::string(text), &words)) return -1;
  std::vector<int32_t> ids;
  ids.reserve(64);
  for (const auto& w : words) wordpiece(*tok, w, &ids);
  int32_t n = std::min<int32_t>(static_cast<int32_t>(ids.size()), out_capacity);
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batched encode: [CLS] ids [SEP] pad to max_len (reference contract,
// mcloader/fashion_gen.py:326-355).  texts are \0-separated; lens[] gives
// offsets.  fallback_mask[i]=1 marks rows needing the Python tokenizer.
void mvlt_encode_batch(void* handle, const char* texts, const int64_t* offsets,
                       int32_t n, int32_t max_len, int32_t* out,
                       uint8_t* fallback_mask) {
  auto* tok = static_cast<Tokenizer*>(handle);
  std::vector<int32_t> scratch(max_len * 4);
  for (int32_t i = 0; i < n; ++i) {
    const char* t = texts + offsets[i];
    int32_t* row = out + static_cast<int64_t>(i) * max_len;
    int32_t got = mvlt_tokenize(handle, t, scratch.data(),
                                static_cast<int32_t>(scratch.size()));
    if (got < 0) {
      fallback_mask[i] = 1;
      continue;
    }
    fallback_mask[i] = 0;
    int32_t keep = std::min(got, max_len - 2);
    row[0] = tok->cls_id;
    std::memcpy(row + 1, scratch.data(), keep * sizeof(int32_t));
    row[keep + 1] = tok->sep_id;
    for (int32_t j = keep + 2; j < max_len; ++j) row[j] = tok->pad_id;
  }
}

// --- image kernel ------------------------------------------------------------

// Whitespace bbox crop (luma < 128 = content) + triangle-filter resize to
// (out_size, out_size), output float32 [0,1] HWC.  Returns 0 on success.
int32_t mvlt_crop_resize(const uint8_t* img, int32_t h, int32_t w,
                         int32_t out_size, int32_t do_crop, float* out) {
  if (h <= 0 || w <= 0 || out_size <= 0) return -1;
  int x0 = 0, y0 = 0, x1 = w, y1 = h;
  if (do_crop) {
    int minx = w, maxx = -1, miny = h, maxy = -1;
    for (int y = 0; y < h; ++y) {
      const uint8_t* rowp = img + static_cast<int64_t>(y) * w * 3;
      for (int x = 0; x < w; ++x) {
        if (luma(rowp + x * 3) < 128) {
          if (x < minx) minx = x;
          if (x > maxx) maxx = x;
          if (y < miny) miny = y;
          if (y > maxy) maxy = y;
        }
      }
    }
    if (maxx >= 0) {
      // reference box (w_min, h_min, w_max, h_max) — PIL crop excludes the
      // max col/row (mcloader/fashion_gen.py:419-424)
      x0 = minx; x1 = std::max(minx + 1, maxx);
      y0 = miny; y1 = std::max(miny + 1, maxy);
    }
  }
  int cw = x1 - x0, ch = y1 - y0;

  auto xc = build_contribs(cw, out_size);
  auto yc = build_contribs(ch, out_size);

  // horizontal pass: [ch, out_size, 3]
  std::vector<double> tmp(static_cast<size_t>(ch) * out_size * 3);
  for (int y = 0; y < ch; ++y) {
    const uint8_t* rowp = img + (static_cast<int64_t>(y0 + y) * w + x0) * 3;
    for (int x = 0; x < out_size; ++x) {
      const Contrib& c = xc[x];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.count; ++k) {
        const uint8_t* px = rowp + (c.lo + k) * 3;
        acc[0] += c.w[k] * px[0];
        acc[1] += c.w[k] * px[1];
        acc[2] += c.w[k] * px[2];
      }
      double* o = &tmp[(static_cast<size_t>(y) * out_size + x) * 3];
      o[0] = acc[0]; o[1] = acc[1]; o[2] = acc[2];
    }
  }
  // vertical pass -> float out
  for (int y = 0; y < out_size; ++y) {
    const Contrib& c = yc[y];
    for (int x = 0; x < out_size; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < c.count; ++k) {
        const double* px = &tmp[(static_cast<size_t>(c.lo + k) * out_size + x) * 3];
        acc[0] += c.w[k] * px[0];
        acc[1] += c.w[k] * px[1];
        acc[2] += c.w[k] * px[2];
      }
      float* o = out + (static_cast<size_t>(y) * out_size + x) * 3;
      // PIL rounds to uint8 between passes; we keep full precision and
      // normalize — within 1 LSB of the PIL path (asserted in tests).
      o[0] = static_cast<float>(acc[0] / 255.0);
      o[1] = static_cast<float>(acc[1] / 255.0);
      o[2] = static_cast<float>(acc[2] / 255.0);
    }
  }
  return 0;
}

// Grid-mask fill: masked_images = where(mask, 1e-6, image) for a batch of
// float32 HWC images and [H,W] masks (mcloader/fashion_gen.py:176).
void mvlt_apply_mask(const float* images, const float* masks, int32_t b,
                     int32_t h, int32_t w, float* out) {
  const float fill = 1e-6f;
  int64_t plane = static_cast<int64_t>(h) * w;
  for (int32_t i = 0; i < b; ++i) {
    const float* img = images + i * plane * 3;
    const float* m = masks + i * plane;
    float* o = out + i * plane * 3;
    for (int64_t p = 0; p < plane; ++p) {
      bool masked = m[p] > 0.5f;
      o[p * 3 + 0] = masked ? fill : img[p * 3 + 0];
      o[p * 3 + 1] = masked ? fill : img[p * 3 + 1];
      o[p * 3 + 2] = masked ? fill : img[p * 3 + 2];
    }
  }
}

}  // extern "C"
