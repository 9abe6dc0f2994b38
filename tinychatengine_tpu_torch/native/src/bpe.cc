// BPE merge engine — C++ core for the three tokenizer families.
//
// The port's copy of the JAX package's native/src/bpe.cc: the analog of
// the reference's C++ tokenizers
// (llm/src/LLaMATokenizer.cc score-based BPE, llm/src/OPTTokenizer.cc and
// llm/src/GPTBigCodeTokenizer.cc byte-level rank BPE, and the llama3.c-style
// tokenizer embedded in llm/src/nn_modules/non_cuda/LLaMA3Generate.cc:279-477).
// The Python layer owns text handling (byte maps, UTF-8 splitting, special
// tokens) and hands this library flat int32 symbol sequences; the merge loop
// — the O(n log n) hot path on long prompts — runs here.
//
// Two merge disciplines:
//   mode 0 (RANK, GPT-2): repeatedly find the lowest-rank pair present and
//     merge every occurrence left-to-right, exactly the reference loop.
//   mode 1 (SCORE, sentencepiece/llama.cpp): agenda of adjacent bigrams
//     ordered by (score desc, position asc), stale entries skipped.
//
// C ABI only (consumed via ctypes; built with g++ at first use).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairInfo {
  int32_t merged_id;
  float priority;  // mode 0: -rank; mode 1: vocab score
};

struct Merger {
  std::unordered_map<uint64_t, PairInfo> table;
  int mode;
};

inline uint64_t key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

// mode 0: rank discipline — merge the LEFTMOST occurrence of the globally
// lowest-rank pair, one merge per iteration (exactly the Python
// tokenizers/bytelevel_bpe.py _bpe loop, so native == fallback bit-for-bit).
int encode_rank(const Merger& m, const int32_t* in, int n_in, int32_t* out,
                int cap) {
  std::vector<int32_t> ids(in, in + n_in);
  for (;;) {
    float best = -1e30f;
    int best_i = -1;
    int32_t best_merged = -1;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      auto it = m.table.find(key(ids[i], ids[i + 1]));
      if (it != m.table.end() && it->second.priority > best) {
        best = it->second.priority;
        best_i = static_cast<int>(i);
        best_merged = it->second.merged_id;
      }
    }
    if (best_i < 0) break;
    ids[best_i] = best_merged;
    ids.erase(ids.begin() + best_i + 1);
  }
  int n = static_cast<int>(ids.size());
  if (n > cap) return -n;
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// mode 1: llama.cpp-style bigram agenda.
struct Bigram {
  float score;
  int left;   // node index
  int right;
  int32_t lid, rid;  // ids at push time (staleness check)
  int32_t merged;
};
struct BigramLess {
  bool operator()(const Bigram& a, const Bigram& b) const {
    if (a.score != b.score) return a.score < b.score;  // max-heap on score
    return a.left > b.left;                            // leftmost wins ties
  }
};

int encode_score(const Merger& m, const int32_t* in, int n_in, int32_t* out,
                 int cap) {
  std::vector<int32_t> id(in, in + n_in);
  std::vector<int> prev(n_in), next(n_in);
  for (int i = 0; i < n_in; ++i) {
    prev[i] = i - 1;
    next[i] = (i + 1 < n_in) ? i + 1 : -1;
  }
  std::priority_queue<Bigram, std::vector<Bigram>, BigramLess> agenda;
  auto push = [&](int l, int r) {
    if (l < 0 || r < 0) return;
    auto it = m.table.find(key(id[l], id[r]));
    if (it == m.table.end()) return;
    agenda.push({it->second.priority, l, r, id[l], id[r],
                 it->second.merged_id});
  };
  for (int i = 0; i + 1 < n_in; ++i) push(i, i + 1);

  std::vector<bool> alive(n_in, true);
  while (!agenda.empty()) {
    Bigram bg = agenda.top();
    agenda.pop();
    if (!alive[bg.left] || !alive[bg.right] || id[bg.left] != bg.lid ||
        id[bg.right] != bg.rid || next[bg.left] != bg.right)
      continue;  // stale
    id[bg.left] = bg.merged;
    alive[bg.right] = false;
    next[bg.left] = next[bg.right];
    if (next[bg.right] >= 0) prev[next[bg.right]] = bg.left;
    push(prev[bg.left], bg.left);
    push(bg.left, next[bg.left]);
  }
  int n = 0;
  for (int i = 0; i >= 0 && i < n_in; i = next[i]) {
    if (!alive[i]) break;  // can't happen from head, defensive
    if (n < cap) out[n] = id[i];
    ++n;
  }
  return n <= cap ? n : -n;
}

// sentencepiece-style whole-text encoder: symbols are byte spans of the
// input; adjacent spans merge when their concatenation is a vocab token,
// best score first (LLaMATokenizer.cc / llama.cpp llm_tokenizer_spm).
struct SpmVocab {
  std::unordered_map<std::string, std::pair<int32_t, float>> map;  // bytes -> (id, score)
  int32_t byte_fallback_base;  // id of byte 0x00's token, or -1
  int32_t unk_id;
};

struct SpmBigram {
  float score;
  int left, right;
  size_t width;  // combined byte width at push time (staleness check)
};
struct SpmLess {
  bool operator()(const SpmBigram& a, const SpmBigram& b) const {
    if (a.score != b.score) return a.score < b.score;
    return a.left > b.left;
  }
};

}  // namespace

extern "C" {

void* tce_spm_create(const uint8_t* blob, const int32_t* lens,
                     const float* scores, int n, int32_t byte_fallback_base,
                     int32_t unk_id) {
  auto* v = new SpmVocab();
  v->byte_fallback_base = byte_fallback_base;
  v->unk_id = unk_id;
  v->map.reserve(static_cast<size_t>(n) * 2);
  const uint8_t* p = blob;
  for (int i = 0; i < n; ++i) {
    std::string tok(reinterpret_cast<const char*>(p), lens[i]);
    p += lens[i];
    v->map[tok] = {i, scores[i]};  // duplicates: last wins (== python dict)
  }
  return v;
}

// Encode UTF-8 text. Initial symbols are UTF-8 characters; unknowns fall
// back to byte tokens (base + byte) or unk_id. Returns n_out (<= n_text).
int tce_spm_encode(void* handle, const uint8_t* text, int n_text,
                   int32_t* out, int cap) {
  auto* v = static_cast<SpmVocab*>(handle);
  if (n_text <= 0) return 0;
  // split into UTF-8 characters
  std::vector<int> start;  // span starts; spans are [start[i], start[i+1])
  start.reserve(n_text + 1);
  for (int i = 0; i < n_text;) {
    start.push_back(i);
    uint8_t c = text[i];
    int len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    if (i + len > n_text) len = 1;
    i += len;
  }
  int n = static_cast<int>(start.size());
  std::vector<int> width(n), prev(n), next(n);
  for (int i = 0; i < n; ++i) {
    int end = (i + 1 < n) ? start[i + 1] : n_text;
    width[i] = end - start[i];
    prev[i] = i - 1;
    next[i] = (i + 1 < n) ? i + 1 : -1;
  }
  auto view = [&](int l, size_t w) {
    return std::string(reinterpret_cast<const char*>(text) + start[l], w);
  };
  std::priority_queue<SpmBigram, std::vector<SpmBigram>, SpmLess> agenda;
  auto push = [&](int l) {
    int r = next[l];
    if (l < 0 || r < 0) return;
    size_t w = width[l] + width[r];
    auto it = v->map.find(view(l, w));
    if (it == v->map.end()) return;
    agenda.push({it->second.second, l, r, w});
  };
  for (int i = 0; i + 1 < n; ++i) push(i);

  std::vector<bool> alive(n, true);
  while (!agenda.empty()) {
    SpmBigram bg = agenda.top();
    agenda.pop();
    if (!alive[bg.left] || !alive[bg.right] || next[bg.left] != bg.right ||
        static_cast<size_t>(width[bg.left] + width[bg.right]) != bg.width)
      continue;
    width[bg.left] += width[bg.right];
    alive[bg.right] = false;
    next[bg.left] = next[bg.right];
    if (next[bg.right] >= 0) prev[next[bg.right]] = bg.left;
    if (prev[bg.left] >= 0) push(prev[bg.left]);
    push(bg.left);
  }

  int n_out = 0;
  for (int i = 0; i >= 0; i = next[i]) {
    auto it = v->map.find(view(i, width[i]));
    if (it != v->map.end()) {
      if (n_out < cap) out[n_out] = it->second.first;
      ++n_out;
    } else if (v->byte_fallback_base >= 0) {
      for (int b = 0; b < width[i]; ++b) {
        if (n_out < cap)
          out[n_out] = v->byte_fallback_base +
                       static_cast<uint8_t>(text[start[i] + b]);
        ++n_out;
      }
    } else {
      if (n_out < cap) out[n_out] = v->unk_id;
      ++n_out;
    }
  }
  return n_out <= cap ? n_out : -n_out;
}

void tce_spm_destroy(void* handle) { delete static_cast<SpmVocab*>(handle); }

void* tce_merger_create(const int32_t* lefts, const int32_t* rights,
                        const int32_t* merged, const float* priority, int n,
                        int mode) {
  auto* m = new Merger();
  m->mode = mode;
  m->table.reserve(static_cast<size_t>(n) * 2);
  for (int i = 0; i < n; ++i) {
    uint64_t k = key(lefts[i], rights[i]);
    auto it = m->table.find(k);
    // keep the highest-priority rule for a pair (duplicates appear when a
    // vocab has multiple merge paths to the same pair)
    if (it == m->table.end() || priority[i] > it->second.priority)
      m->table[k] = {merged[i], priority[i]};
  }
  return m;
}

int tce_merger_encode(void* handle, const int32_t* in, int n_in, int32_t* out,
                      int cap) {
  auto* m = static_cast<Merger*>(handle);
  if (n_in <= 0) return 0;
  return m->mode == 0 ? encode_rank(*m, in, n_in, out, cap)
                      : encode_score(*m, in, n_in, out, cap);
}

void tce_merger_destroy(void* handle) { delete static_cast<Merger*>(handle); }

}  // extern "C"
