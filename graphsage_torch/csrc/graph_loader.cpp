// Native data-plane for graphsage_torch: TSV dataset parsing + CSR building.
//
// The reference's loaders are pure-Python line loops (reference
// graphsage/model.py:39-63, 108-135); at Cora scale that is fine, but this
// framework targets multi-million-edge graphs (BASELINE.json config #4/#5)
// where host-side parsing and adjacency construction become the input
// bottleneck. This library provides:
//
//   * gsl_parse_cora    — cora.content/cora.cites format (label ids by first
//                         appearance, matching quirk Q14)
//   * gsl_parse_pubmed  — Pubmed-Diabetes NODE/DIRECTED.cites tabs (header
//                         feature map, label=<n>-1, summary field skipped —
//                         quirk Q15)
//   * gsl_build_csr     — undirected/directed dedup'd CSR from an edge list
//
// Exposed through a plain C ABI, consumed from Python via ctypes
// (graphsage_torch/data/native.py). Parsing semantics are pinned by parity
// tests against the numpy reference parsers.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Dataset {
  int64_t num_nodes = 0;
  int64_t num_feats = 0;
  int64_t num_classes = 0;
  std::vector<float> features;     // [N * F]
  std::vector<int32_t> labels;     // [N]
  std::vector<int64_t> edges;      // [E * 2]
  std::string error;
};

struct Csr {
  std::vector<int64_t> indptr;    // [N + 1]
  std::vector<int64_t> indices;   // [E_dedup]
};

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

// Iterate lines of a buffer without copying.
struct LineIter {
  const char* p;
  const char* end;
  explicit LineIter(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}
  bool next(const char** line, size_t* len) {
    if (p >= end) return false;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    *line = p;
    *len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    p = nl ? nl + 1 : end;
    // strip trailing \r
    if (*len && (*line)[*len - 1] == '\r') --*len;
    return true;
  }
};

std::vector<std::pair<const char*, size_t>> split(const char* line, size_t len,
                                                  char sep) {
  std::vector<std::pair<const char*, size_t>> out;
  const char* p = line;
  const char* end = line + len;
  while (p <= end) {
    const char* s = static_cast<const char*>(memchr(p, sep, end - p));
    if (!s) {
      out.emplace_back(p, static_cast<size_t>(end - p));
      break;
    }
    out.emplace_back(p, static_cast<size_t>(s - p));
    p = s + 1;
  }
  return out;
}

// Whitespace split (any run of spaces/tabs), like Python str.split().
std::vector<std::pair<const char*, size_t>> wsplit(const char* line, size_t len) {
  std::vector<std::pair<const char*, size_t>> out;
  const char* p = line;
  const char* end = line + len;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    const char* s = p;
    while (p < end && *p != ' ' && *p != '\t') ++p;
    if (p > s) out.emplace_back(s, static_cast<size_t>(p - s));
  }
  return out;
}

std::string tok_str(const std::pair<const char*, size_t>& t) {
  return std::string(t.first, t.second);
}

double tok_float(const std::pair<const char*, size_t>& t) {
  return std::strtod(std::string(t.first, t.second).c_str(), nullptr);
}

}  // namespace

extern "C" {

Dataset* gsl_parse_cora(const char* content_path, const char* cites_path) {
  auto* ds = new Dataset();
  std::string content, cites;
  if (!read_file(content_path, &content)) {
    ds->error = std::string("cannot read ") + content_path;
    return ds;
  }
  if (!read_file(cites_path, &cites)) {
    ds->error = std::string("cannot read ") + cites_path;
    return ds;
  }

  std::unordered_map<std::string, int64_t> node_map;
  std::unordered_map<std::string, int32_t> label_map;

  LineIter it(content);
  const char* line;
  size_t len;
  int64_t f = -1;
  while (it.next(&line, &len)) {
    auto toks = wsplit(line, len);
    if (toks.empty()) continue;
    if (f < 0) f = static_cast<int64_t>(toks.size()) - 2;
    node_map[tok_str(toks[0])] = ds->num_nodes;
    for (int64_t j = 0; j < f; ++j)
      ds->features.push_back(static_cast<float>(tok_float(toks[1 + j])));
    std::string lab = tok_str(toks.back());
    auto ins = label_map.emplace(lab, static_cast<int32_t>(label_map.size()));
    ds->labels.push_back(ins.first->second);
    ++ds->num_nodes;
  }
  ds->num_feats = f < 0 ? 0 : f;
  ds->num_classes = static_cast<int64_t>(label_map.size());

  LineIter ct(cites);
  while (ct.next(&line, &len)) {
    auto toks = wsplit(line, len);
    if (toks.size() < 2) continue;
    auto a = node_map.find(tok_str(toks[0]));
    auto b = node_map.find(tok_str(toks[1]));
    if (a == node_map.end() || b == node_map.end()) {
      ds->error = "cites references unknown node id";
      return ds;
    }
    ds->edges.push_back(a->second);
    ds->edges.push_back(b->second);
  }
  return ds;
}

Dataset* gsl_parse_pubmed(const char* node_path, const char* cites_path) {
  auto* ds = new Dataset();
  std::string nodes, cites;
  if (!read_file(node_path, &nodes)) {
    ds->error = std::string("cannot read ") + node_path;
    return ds;
  }
  if (!read_file(cites_path, &cites)) {
    ds->error = std::string("cannot read ") + cites_path;
    return ds;
  }

  LineIter it(nodes);
  const char* line;
  size_t len;
  if (!it.next(&line, &len)) {  // banner
    ds->error = "empty node file";
    return ds;
  }
  if (!it.next(&line, &len)) {  // header with feature names
    ds->error = "missing header line";
    return ds;
  }
  // Header entries "numeric:<word>:0.0": word at column index entry-1.
  std::unordered_map<std::string, int64_t> feat_col;
  {
    auto entries = split(line, len, '\t');
    for (size_t i = 0; i < entries.size(); ++i) {
      auto parts = split(entries[i].first, entries[i].second, ':');
      if (parts.size() >= 2)
        feat_col[tok_str(parts[1])] = static_cast<int64_t>(i) - 1;
    }
  }
  int64_t f = static_cast<int64_t>(feat_col.size()) - 1;  // minus label entry
  ds->num_feats = f;

  std::unordered_map<std::string, int64_t> node_map;
  std::vector<std::vector<std::pair<int64_t, float>>> sparse_rows;
  while (it.next(&line, &len)) {
    auto toks = split(line, len, '\t');
    if (toks.size() < 2) continue;
    node_map[tok_str(toks[0])] = ds->num_nodes;
    auto lab = split(toks[1].first, toks[1].second, '=');
    ds->labels.push_back(
        static_cast<int32_t>(std::strtol(tok_str(lab[1]).c_str(), nullptr, 10) - 1));
    sparse_rows.emplace_back();
    auto& row = sparse_rows.back();
    // fields 2..size-2 are word=value; last field is the summary (skipped).
    for (size_t j = 2; j + 1 < toks.size(); ++j) {
      auto kv = split(toks[j].first, toks[j].second, '=');
      if (kv.size() != 2) continue;
      auto col = feat_col.find(tok_str(kv[0]));
      if (col == feat_col.end()) {
        ds->error = "unknown feature name in node row";
        return ds;
      }
      row.emplace_back(col->second, static_cast<float>(tok_float(kv[1])));
    }
    ++ds->num_nodes;
  }
  ds->num_classes = 3;
  ds->features.assign(static_cast<size_t>(ds->num_nodes * f), 0.0f);
  for (int64_t i = 0; i < ds->num_nodes; ++i)
    for (auto& kv : sparse_rows[static_cast<size_t>(i)])
      ds->features[static_cast<size_t>(i * f + kv.first)] = kv.second;

  LineIter ct(cites);
  if (!ct.next(&line, &len) || !ct.next(&line, &len)) {
    ds->error = "cites file missing header lines";
    return ds;
  }
  while (ct.next(&line, &len)) {
    auto toks = split(line, len, '\t');
    if (toks.size() < 2) continue;
    auto first = split(toks[1].first, toks[1].second, ':');
    auto last = split(toks.back().first, toks.back().second, ':');
    auto a = node_map.find(tok_str(first.back()));
    auto b = node_map.find(tok_str(last.back()));
    if (a == node_map.end() || b == node_map.end()) {
      ds->error = "cites references unknown paper id";
      return ds;
    }
    ds->edges.push_back(a->second);
    ds->edges.push_back(b->second);
  }
  return ds;
}

const char* gsl_error(Dataset* ds) { return ds->error.empty() ? nullptr : ds->error.c_str(); }
int64_t gsl_num_nodes(Dataset* ds) { return ds->num_nodes; }
int64_t gsl_num_feats(Dataset* ds) { return ds->num_feats; }
int64_t gsl_num_classes(Dataset* ds) { return ds->num_classes; }
int64_t gsl_num_edges(Dataset* ds) { return static_cast<int64_t>(ds->edges.size() / 2); }

void gsl_copy_features(Dataset* ds, float* out) {
  std::memcpy(out, ds->features.data(), ds->features.size() * sizeof(float));
}
void gsl_copy_labels(Dataset* ds, int32_t* out) {
  std::memcpy(out, ds->labels.data(), ds->labels.size() * sizeof(int32_t));
}
void gsl_copy_edges(Dataset* ds, int64_t* out) {
  std::memcpy(out, ds->edges.data(), ds->edges.size() * sizeof(int64_t));
}
void gsl_free(Dataset* ds) { delete ds; }

// ---- Range parsers for the LAZY ingestion path ---------------------------
// The pod-scale loaders (data/loaders.py load_*_lazy) record each content
// line's byte offset at index time and fetch feature ROWS on demand —
// these functions parse exactly the requested lines, never the whole file,
// so per-host RAM stays N/M rows on an M-process pod. ``offsets``/``lens``
// are the line start offsets and byte lengths. A trailing newline in the
// buffer is tolerated, but NOT because wsplit treats it as whitespace (it
// does not — it splits on ' '/'\t' only): it lands inside the final token,
// which both row parsers skip (Cora's label / Pubmed's summary field); the
// pubmed parser additionally strips trailing \r\n explicitly. Returns 0
// on success.

namespace {
// 64-bit-safe seek: plain fseek takes long, which is 32 bits on LLP64 —
// offsets past 2 GiB (exactly the pod-scale files this path exists for)
// would wrap and silently parse the wrong rows.
int seek64(FILE* f, int64_t off) {
#ifdef _WIN32
  return _fseeki64(f, off, SEEK_SET);
#else
  return fseeko(f, static_cast<off_t>(off), SEEK_SET);
#endif
}
}  // namespace

int gsl_cora_feature_rows(const char* content_path, const int64_t* offsets,
                          const int64_t* lens, int64_t n_rows,
                          int64_t num_feats, float* out) {
  FILE* f = std::fopen(content_path, "rb");
  if (!f) return 1;
  std::string buf;
  for (int64_t i = 0; i < n_rows; ++i) {
    if (seek64(f, offsets[i]) != 0 ||
        (buf.resize(static_cast<size_t>(lens[i])),
         lens[i] && std::fread(&buf[0], 1, static_cast<size_t>(lens[i]), f) !=
                        static_cast<size_t>(lens[i]))) {
      std::fclose(f);
      return 2;
    }
    auto toks = wsplit(buf.data(), buf.size());
    if (static_cast<int64_t>(toks.size()) < num_feats + 2) {
      std::fclose(f);
      return 3;
    }
    for (int64_t j = 0; j < num_feats; ++j)
      out[i * num_feats + j] = static_cast<float>(tok_float(toks[1 + j]));
  }
  std::fclose(f);
  return 0;
}

int gsl_pubmed_feature_rows(const char* node_path, const int64_t* offsets,
                            const int64_t* lens, int64_t n_rows,
                            int64_t num_feats, float* out) {
  // Rebuild the header word->column map (Q15: entry j names column j-1),
  // then parse only the requested rows.
  FILE* f = std::fopen(node_path, "rb");
  if (!f) return 1;
  std::string header;
  {
    // Skip the banner line, read the header line.
    int c;
    while ((c = std::fgetc(f)) != EOF && c != '\n') {
    }
    while ((c = std::fgetc(f)) != EOF && c != '\n') header.push_back((char)c);
    if (!header.empty() && header.back() == '\r') header.pop_back();
  }
  std::unordered_map<std::string, int64_t> feat_col;
  {
    auto cols = split(header.data(), header.size(), '\t');
    for (size_t j = 0; j < cols.size(); ++j) {
      auto parts = split(cols[j].first, cols[j].second, ':');
      if (parts.size() >= 2)
        feat_col[tok_str(parts[1])] = static_cast<int64_t>(j) - 1;
    }
  }
  std::string buf;
  for (int64_t i = 0; i < n_rows; ++i) {
    if (seek64(f, offsets[i]) != 0 ||
        (buf.resize(static_cast<size_t>(lens[i])),
         lens[i] && std::fread(&buf[0], 1, static_cast<size_t>(lens[i]), f) !=
                        static_cast<size_t>(lens[i]))) {
      std::fclose(f);
      return 2;
    }
    size_t blen = buf.size();
    while (blen && (buf[blen - 1] == '\n' || buf[blen - 1] == '\r')) --blen;
    auto fields = split(buf.data(), blen, '\t');
    if (fields.size() < 3) {
      std::fclose(f);
      return 3;
    }
    float* row = out + i * num_feats;
    std::memset(row, 0, sizeof(float) * static_cast<size_t>(num_feats));
    // fields[2:-1]: word=value pairs; the final field (summary) is skipped.
    for (size_t t = 2; t + 1 < fields.size(); ++t) {
      const char* eq = static_cast<const char*>(
          memchr(fields[t].first, '=', fields[t].second));
      if (!eq) continue;
      std::string name(fields[t].first,
                       static_cast<size_t>(eq - fields[t].first));
      auto it2 = feat_col.find(name);
      if (it2 == feat_col.end() || it2->second < 0 ||
          it2->second >= num_feats) {
        std::fclose(f);
        return 4;
      }
      row[it2->second] = static_cast<float>(
          std::strtod(std::string(eq + 1, fields[t].first + fields[t].second)
                          .c_str(),
                      nullptr));
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------- CSR build

Csr* gsl_build_csr(int64_t num_nodes, const int64_t* edges, int64_t num_edges,
                   int undirected) {
  auto* csr = new Csr();
  std::vector<std::pair<int64_t, int64_t>> pairs;
  pairs.reserve(static_cast<size_t>(undirected ? 2 * num_edges : num_edges));
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t a = edges[2 * e], b = edges[2 * e + 1];
    pairs.emplace_back(a, b);
    if (undirected) pairs.emplace_back(b, a);
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());

  csr->indptr.assign(static_cast<size_t>(num_nodes + 1), 0);
  csr->indices.reserve(pairs.size());
  for (auto& p : pairs) {
    ++csr->indptr[static_cast<size_t>(p.first + 1)];
    csr->indices.push_back(p.second);
  }
  for (int64_t v = 0; v < num_nodes; ++v)
    csr->indptr[static_cast<size_t>(v + 1)] += csr->indptr[static_cast<size_t>(v)];
  return csr;
}

int64_t gsl_csr_nnz(Csr* csr) { return static_cast<int64_t>(csr->indices.size()); }
void gsl_csr_copy_indptr(Csr* csr, int64_t* out) {
  std::memcpy(out, csr->indptr.data(), csr->indptr.size() * sizeof(int64_t));
}
void gsl_csr_copy_indices(Csr* csr, int64_t* out) {
  std::memcpy(out, csr->indices.data(), csr->indices.size() * sizeof(int64_t));
}
void gsl_csr_free(Csr* csr) { delete csr; }

}  // extern "C"
