// Fast SDPA-sparse (.dat-s) parser.
//
// Equivalent of the reference's data loader
// (reference: test/base_sdplib.jl:1-45, which uses DelimitedFiles.readdlm —
// O(file) allocations in Julia).  This parser is a single-pass scanner with
// no per-token allocation; exposed to Python through ctypes (utils/native.py)
// and used by proxsdp_tpu.models.sdplib when built.
//
// Output convention matches the Python fallback parser:
//   entries[k] = {matno, i, j, val} with 1-based i<=j indices offset into
//   the big embedded block matrix, and F0 (matno==0) values NEGATED.
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
  int64_t n = 0;       // side of the embedded block matrix
  int64_t m = 0;       // number of constraints
  std::vector<double> c;        // length m
  std::vector<double> entries;  // flat rows of [matno, i, j, val]
};

// skip to next token; returns nullptr at end of buffer
const char* skip_ws(const char* p, const char* end) {
  while (p < end && (std::isspace(static_cast<unsigned char>(*p)) ||
                     *p == ',' || *p == '{' || *p == '}' || *p == '(' ||
                     *p == ')')) {
    ++p;
  }
  return p < end ? p : nullptr;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : nullptr;
}

bool is_comment(const char* p) {
  return *p == '*' || *p == '"' || *p == '\'';
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* sdpa_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (rd != static_cast<size_t>(size)) return nullptr;
  buf[rd] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + rd;

  // skip comment lines
  while (p && p < end) {
    const char* q = skip_ws(p, end);
    if (!q) return nullptr;
    if (is_comment(q)) {
      p = next_line(q, end);
    } else {
      p = q;
      break;
    }
  }
  if (!p) return nullptr;

  auto parsed = new Parsed();
  char* nxt = nullptr;

  long m = std::strtol(p, &nxt, 10);
  p = skip_ws(nxt, end);
  if (!p) { delete parsed; return nullptr; }
  long nblocks = std::strtol(p, &nxt, 10);
  p = skip_ws(nxt, end);
  if (!p) { delete parsed; return nullptr; }

  std::vector<int64_t> cum(static_cast<size_t>(nblocks) + 1, 0);
  for (long b = 0; b < nblocks; ++b) {
    double bs = std::strtod(p, &nxt);
    cum[static_cast<size_t>(b) + 1] =
        cum[static_cast<size_t>(b)] +
        static_cast<int64_t>(std::llabs(static_cast<long long>(bs)));
    p = skip_ws(nxt, end);
    if (!p) { delete parsed; return nullptr; }
  }
  parsed->n = cum[static_cast<size_t>(nblocks)];
  parsed->m = m;
  parsed->c.resize(static_cast<size_t>(m));
  for (long k = 0; k < m; ++k) {
    parsed->c[static_cast<size_t>(k)] = std::strtod(p, &nxt);
    p = skip_ws(nxt, end);
    if (!p && k + 1 < m) { delete parsed; return nullptr; }
  }

  while (p) {
    // comment lines may appear anywhere in the entry section too —
    // skip them the same way the Python fallback does
    if (is_comment(p)) {
      p = next_line(p, end);
      if (p) p = skip_ws(p, end);
      continue;
    }
    long matno = std::strtol(p, &nxt, 10);
    p = skip_ws(nxt, end);
    if (!p) break;
    long blk = std::strtol(p, &nxt, 10);
    p = skip_ws(nxt, end);
    if (!p) break;
    long i = std::strtol(p, &nxt, 10);
    p = skip_ws(nxt, end);
    if (!p) break;
    long j = std::strtol(p, &nxt, 10);
    p = skip_ws(nxt, end);
    if (!p) break;
    double val = std::strtod(p, &nxt);
    p = skip_ws(nxt, end);

    int64_t off = cum[static_cast<size_t>(blk - 1)];
    int64_t ii = i + off, jj = j + off;
    if (ii > jj) { int64_t t = ii; ii = jj; jj = t; }
    if (matno == 0) val = -val;  // match the reference's F0 negation
    parsed->entries.push_back(static_cast<double>(matno));
    parsed->entries.push_back(static_cast<double>(ii));
    parsed->entries.push_back(static_cast<double>(jj));
    parsed->entries.push_back(val);
  }
  return parsed;
}

int64_t sdpa_n(void* h) { return static_cast<Parsed*>(h)->n; }
int64_t sdpa_m(void* h) { return static_cast<Parsed*>(h)->m; }
int64_t sdpa_nnz(void* h) {
  return static_cast<int64_t>(static_cast<Parsed*>(h)->entries.size() / 4);
}
const double* sdpa_c(void* h) { return static_cast<Parsed*>(h)->c.data(); }
const double* sdpa_entries(void* h) {
  return static_cast<Parsed*>(h)->entries.data();
}
void sdpa_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
