// vidcap_tpu_torch native host library: the port's copy of the JAX
// package's C++ host library, built with g++ into build/vidcap_tpu_torch/ on
// first use and loaded with ctypes by vidcap_tpu_torch/native.py.
//
//   * vc_tokenize        — PTB-style caption tokenization (parity with
//                          data/vocab.ptb_tokenize)
//   * vc_ngram_hash      — 64-bit (2×u32 lane) n-gram hashing, bit-identical to
//                          ops/ngram_hash.py's host and device versions
//   * vc_ref_ngrams      — per-reference n-gram counting + hashing for the
//                          device CIDEr reward tables (the O(corpus) host-side
//                          build step in objectives/reward_tables.py)
//   * vc_encode_batch    — caption id-encode + pad (vocab lookup done in Python;
//                          this packs/pads fixed-shape batches)
//
// Plain C ABI. Every entry point has a Python counterpart that runs where
// no compiler is found. The code below the includes is kept identical to the
// JAX package's copy, so that both count a reference's n-grams in the same
// order (std::unordered_map's iteration order) and build equal tables.

#include <cstdint>
#include <cstring>
#include <cctype>
#include <unordered_map>
#include <vector>

extern "C" {

// ---- hashing (MUST stay bit-identical to ops/ngram_hash.py) -----------------

static const uint32_t M1 = 0x01000193u;   // FNV-1a prime, lane 1
static const uint32_t M2 = 0x85EBCA6Bu;   // murmur3 c1, lane 2
static const uint32_t ADDC = 0x9E3779B9u; // golden-ratio constant
static const uint32_t SEED1[4] = {0x811C9DC5u, 0x1000193Fu, 0x2F0E1B85u,
                                  0x5BD1E995u};
static const uint32_t SEED2[4] = {0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u,
                                  0x9E3779B1u};

static inline uint32_t mix(uint32_t h, uint32_t t, uint32_t m) {
  h ^= (t + ADDC);
  h *= m;
  h ^= h >> 15;
  return h;
}

void vc_ngram_hash(const int32_t* tokens, int n, uint32_t* lo, uint32_t* hi) {
  uint32_t h1 = SEED1[n - 1], h2 = SEED2[n - 1];
  for (int i = 0; i < n; ++i) {
    h1 = mix(h1, (uint32_t)tokens[i], M1);
    h2 = mix(h2, (uint32_t)tokens[i], M2);
  }
  *lo = h1;
  *hi = h2;
}

// ---- per-reference n-gram table entries -------------------------------------
// For one token sequence, emit unique n-grams of orders 1..4 with term
// frequencies. Returns the number of entries written, or -1 if cap exceeded.

int vc_ref_ngrams(const int32_t* tokens, int len, int max_order,
                  uint32_t* out_lo, uint32_t* out_hi, float* out_tf,
                  int32_t* out_order, int cap) {
  int written = 0;
  for (int n = 1; n <= max_order; ++n) {
    std::unordered_map<uint64_t, int> counts;
    std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>> keys;
    for (int i = 0; i + n <= len; ++i) {
      uint32_t lo, hi;
      vc_ngram_hash(tokens + i, n, &lo, &hi);
      uint64_t k = ((uint64_t)hi << 32) | lo;
      counts[k]++;
      keys[k] = {lo, hi};
    }
    for (auto& kv : counts) {
      if (written >= cap) return -1;
      out_lo[written] = keys[kv.first].first;
      out_hi[written] = keys[kv.first].second;
      out_tf[written] = (float)kv.second;
      out_order[written] = n;
      ++written;
    }
  }
  return written;
}

// ---- PTB-style tokenization --------------------------------------------------
// Parity with data/vocab.ptb_tokenize: lowercase; every char in the punctuation
// set ["'`!?,;:.\-_()[]{}<>@#$%^&*+=~/\\|] becomes a space (note: the Python
// regex's &amp;/&lt;/&gt;/... alternatives are unreachable — '&','<','.','>'
// are already in the char class — so char-by-char is exact parity);
// whitespace-collapse; split.

static inline bool is_punct(char c) {
  static const char* P = "\"'`!?,;:.-_()[]{}<>@#$%^&*+=~/\\|";
  return strchr(P, c) != nullptr;
}

int vc_tokenize(const char* text, char* out, int out_cap) {
  std::vector<char> buf;
  size_t len = strlen(text);
  buf.reserve(len + 1);
  for (size_t i = 0; i < len; ++i) {
    char c = (char)tolower((unsigned char)text[i]);
    buf.push_back(is_punct(c) || isspace((unsigned char)c) ? ' ' : c);
  }
  // collapse whitespace
  int w = 0;
  bool in_space = true;
  for (char c : buf) {
    if (c == ' ') {
      if (!in_space && w < out_cap - 1) out[w++] = ' ';
      in_space = true;
    } else {
      if (w < out_cap - 1) out[w++] = c;
      in_space = false;
    }
  }
  while (w > 0 && out[w - 1] == ' ') --w;
  out[w] = '\0';
  return w;
}

// ---- batch packing -----------------------------------------------------------
// rows: concatenated token ids; row_len[i] lengths. Writes [num, max_len]
// id matrix (eos-terminated, zero-padded) and the float mask.

void vc_encode_batch(const int32_t* rows, const int32_t* row_len, int num,
                     int max_len, int32_t eos_id, int32_t* out_tokens,
                     float* out_mask) {
  int off = 0;
  for (int r = 0; r < num; ++r) {
    int L = row_len[r];
    int keep = L < max_len - 1 ? L : max_len - 1;
    for (int j = 0; j < keep; ++j) out_tokens[r * max_len + j] = rows[off + j];
    out_tokens[r * max_len + keep] = eos_id;
    for (int j = keep + 1; j < max_len; ++j) out_tokens[r * max_len + j] = 0;
    for (int j = 0; j <= keep; ++j) out_mask[r * max_len + j] = 1.0f;
    for (int j = keep + 1; j < max_len; ++j) out_mask[r * max_len + j] = 0.0f;
    off += L;
  }
}

}  // extern "C"
