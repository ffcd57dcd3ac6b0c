// pipetpu_io: native corpus processing for the LM data pipeline.
//
// The reference framework's data loading rides torchtext's C++ kernels; this
// library is the host-side input path: one-pass basic_english tokenization
// + first-appearance vocabulary + id stream over a text corpus, exposed
// through a C ABI consumed via ctypes (pipe_tpu_torch/data/native.py).
// Semantics mirror pipe_tpu_torch.data.lm_text exactly (ASCII lowercase;
// '";:' dropped; ".,!?()'" isolated; whitespace split; empty lines dropped;
// <unk>=0 then first-appearance order), which tests/test_torch_native.py
// asserts token for token. A copy of the root csrc/pipetpu_io.cpp.
//
// Build (data/native.py does it at first use, into build/native/):
//   g++ -O3 -std=c++17 -shared -fPIC pipetpu_io.cpp -o libpipetpu_io.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Corpus {
  std::vector<int32_t> ids;
  std::vector<std::string> vocab;  // vocab[0] == "<unk>"
  std::unordered_map<std::string, int32_t> index;
};

inline bool is_drop(char c) { return c == '"' || c == ';' || c == ':'; }
inline bool is_isolate(char c) {
  return c == '.' || c == ',' || c == '!' || c == '?' || c == '(' ||
         c == ')' || c == '\'';
}

void process_line(Corpus& corpus, std::string_view line,
                  std::string& scratch) {
  scratch.clear();
  scratch.reserve(line.size() + 16);
  for (char c : line) {
    if (is_drop(c)) {
      scratch.push_back(' ');
    } else if (is_isolate(c)) {
      scratch.push_back(' ');
      scratch.push_back(c);
      scratch.push_back(' ');
    } else if (c >= 'A' && c <= 'Z') {
      scratch.push_back(static_cast<char>(c - 'A' + 'a'));
    } else if (c == '\t' || c == '\r' || c == '\n' || c == '\f' ||
               c == '\v') {
      scratch.push_back(' ');
    } else {
      scratch.push_back(c);
    }
  }
  size_t i = 0, n = scratch.size();
  while (i < n) {
    while (i < n && scratch[i] == ' ') ++i;
    size_t start = i;
    while (i < n && scratch[i] != ' ') ++i;
    if (i > start) {
      std::string tok = scratch.substr(start, i - start);
      auto it = corpus.index.find(tok);
      int32_t id;
      if (it == corpus.index.end()) {
        id = static_cast<int32_t>(corpus.vocab.size());
        corpus.index.emplace(tok, id);
        corpus.vocab.push_back(std::move(tok));
      } else {
        id = it->second;
      }
      corpus.ids.push_back(id);
    }
  }
}

Corpus* build(const char* data, size_t len) {
  auto* corpus = new Corpus();
  corpus->vocab.emplace_back("<unk>");
  corpus->index.emplace("<unk>", 0);
  std::string scratch;
  size_t pos = 0;
  while (pos < len) {
    const char* nl =
        static_cast<const char*>(memchr(data + pos, '\n', len - pos));
    size_t end = nl ? static_cast<size_t>(nl - data) : len;
    process_line(*corpus, std::string_view(data + pos, end - pos), scratch);
    pos = end + 1;
  }
  return corpus;
}

}  // namespace

extern "C" {

Corpus* ptio_from_bytes(const char* data, int64_t len) {
  if (len < 0) return nullptr;
  try {
    return build(data, static_cast<size_t>(len));
  } catch (...) {
    return nullptr;  // never let a C++ exception cross the C ABI
  }
}

Corpus* ptio_from_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return nullptr; }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return nullptr; }
  try {
    std::vector<char> buf(static_cast<size_t>(size));
    size_t got = fread(buf.data(), 1, buf.size(), f);
    fclose(f);
    return build(buf.data(), got);
  } catch (...) {
    fclose(f);
    return nullptr;
  }
}

int64_t ptio_num_tokens(const Corpus* c) {
  return static_cast<int64_t>(c->ids.size());
}

int32_t ptio_vocab_size(const Corpus* c) {
  return static_cast<int32_t>(c->vocab.size());
}

void ptio_copy_ids(const Corpus* c, int32_t* out) {
  memcpy(out, c->ids.data(), c->ids.size() * sizeof(int32_t));
}

const char* ptio_token(const Corpus* c, int32_t id) {
  if (id < 0 || id >= static_cast<int32_t>(c->vocab.size())) return nullptr;
  return c->vocab[static_cast<size_t>(id)].c_str();
}

int32_t ptio_lookup(const Corpus* c, const char* token) {
  auto it = c->index.find(token);
  return it == c->index.end() ? 0 : it->second;
}

void ptio_free(Corpus* c) { delete c; }

}  // extern "C"
