// Native host-side graph builder: edge-list text -> densified CSR + Vose alias
// tables + per-vertex open-addressing membership tables.
//
// This is the framework's counterpart of the reference's graph-build stage
// (reference UniformRandomWalk.scala:17-88 / VCutRandomWalk.scala:13-98, which lean on
// the Spark engine's shuffle machinery): a one-time host preprocessing pass before the
// arrays are uploaded to device memory. The pure-Python builder in graph/csr.py has the same
// semantics but loops per line / per row, which is too slow beyond ~1M edges; this
// C++ path handles LiveJournal-scale inputs. Exposed via a C ABI consumed with ctypes
// (native/__init__.py); bit-identical outputs are enforced by
// tests/test_torch_host.py.
//
// Parsing semantics (must match graph/io.py exactly):
//   uniform: weight = last col IF (weighted && cols > 2) else 1.0 (junk -> 1.0);
//   undirected doubles arcs; directed registers dst as (possibly degree-0) vertex;
//   multi-edges preserved; dense ids by first appearance; rows sorted by dense dst.
//   partitioned: pid = col2 IF (partitioned && cols > 2) else random in [0, nparts);
//   weight needs cols > 3; home(v) = pid of v's first record in file order.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kHashMult = 2654435761u;
constexpr int kHashMaxProbes = 4;

struct Graph {
  int64_t V = 0, E = 0, H = 0;
  std::vector<int64_t> ids;
  std::vector<int64_t> offsets;
  std::vector<int32_t> cols;
  std::vector<float> weights;
  std::vector<float> alias_prob;
  std::vector<int32_t> alias_pos;
  std::vector<int64_t> hash_offsets;
  std::vector<int32_t> hash_mask;
  std::vector<int32_t> hash_table;
  std::vector<int32_t> home;  // vcut home partition per dense id (or -1)
};

float parse_weight_or_one(const char* tok) {
  char* end = nullptr;
  float w = std::strtof(tok, &end);
  if (end == tok || (end && *end != '\0')) return 1.0f;
  return w;
}

// Split whitespace tokens in-place; returns token count (up to max_tok).
int tokenize(char* line, char** toks, int max_tok) {
  int n = 0;
  char* p = line;
  while (*p && n < max_tok) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) break;
    toks[n++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

void build_alias_row(const float* w, int64_t d, float* prob, int32_t* pos) {
  if (d == 0) return;
  double sum = 0;
  for (int64_t i = 0; i < d; ++i) sum += w[i];
  std::vector<double> scaled(d);
  for (int64_t i = 0; i < d; ++i)
    scaled[i] = (sum > 0 ? w[i] / sum : 1.0 / d) * d;
  std::vector<int32_t> small, large;
  small.reserve(d);
  large.reserve(d);
  for (int64_t i = 0; i < d; ++i) {
    prob[i] = 1.0f;
    pos[i] = static_cast<int32_t>(i);
    (scaled[i] < 1.0 ? small : large).push_back(static_cast<int32_t>(i));
  }
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back();
    small.pop_back();
    int32_t l = large.back();
    prob[s] = static_cast<float>(scaled[s]);
    pos[s] = l;
    scaled[l] -= 1.0 - scaled[s];
    if (scaled[l] < 1.0) {
      large.pop_back();
      small.push_back(l);
    }
  }
}

// Open-addressing table for one row; grows until every key fits in kHashMaxProbes.
//
// Placement is ROUND-based, not sequential-insertion, to be bit-identical with the
// vectorized Python builder (graph/csr.py build_hash_tables): in round i every
// still-unplaced key attempts probe slot (h + i) & mask; only slots free at the START
// of the round are candidates; ties within a round go to the lowest key index
// (keys are sorted ascending, matching the Python global key order). A key never
// re-tries an earlier probe index.
void build_hash_row(const int32_t* keys_begin, int64_t d,
                    std::vector<int32_t>& out, int32_t& mask) {
  std::vector<int32_t> keys(keys_begin, keys_begin + d);
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  const int64_t nk = static_cast<int64_t>(keys.size());
  int64_t size = 8;
  while (size < 2 * (nk ? nk : 1)) size *= 2;
  for (;;) {
    std::vector<int32_t> table(size, -1);
    const int64_t m = size - 1;
    std::vector<int32_t> unplaced(nk);
    for (int64_t i = 0; i < nk; ++i) unplaced[i] = static_cast<int32_t>(i);
    for (int round = 0; round < kHashMaxProbes && !unplaced.empty(); ++round) {
      // (slot, key index) for every unplaced key whose slot is free pre-round.
      std::vector<std::pair<int64_t, int32_t>> cand;
      cand.reserve(unplaced.size());
      for (int32_t ki : unplaced) {
        int64_t h = static_cast<int64_t>(
            static_cast<uint32_t>(keys[ki]) * kHashMult);
        int64_t slot = (h + round) & m;
        if (table[slot] == -1) cand.emplace_back(slot, ki);
      }
      std::stable_sort(cand.begin(), cand.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      std::vector<bool> placed(nk, false);
      int64_t prev_slot = -1;
      for (const auto& [slot, ki] : cand) {
        if (slot != prev_slot) {
          table[slot] = keys[ki];
          placed[ki] = true;
          prev_slot = slot;
        }
      }
      std::vector<int32_t> next;
      next.reserve(unplaced.size());
      for (int32_t ki : unplaced)
        if (!placed[ki]) next.push_back(ki);
      unplaced = std::move(next);
    }
    if (unplaced.empty()) {
      mask = static_cast<int32_t>(m);
      out = std::move(table);
      return;
    }
    size *= 2;
  }
}

}  // namespace

extern "C" {

// Returns an opaque Graph*; nullptr on failure (e.g. unreadable file).
void* srw_build(const char* path, int weighted, int directed, int partitioned,
                int num_partitions, uint64_t seed) {
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto* g = new Graph();
  std::unordered_map<int64_t, int32_t> id_map;
  std::vector<std::vector<std::pair<int32_t, float>>> adj;
  std::vector<int32_t> home;
  std::mt19937_64 rng(seed);
  adj.reserve(1 << 16);

  auto dense = [&](int64_t orig) -> int32_t {
    auto it = id_map.find(orig);
    if (it != id_map.end()) return it->second;
    int32_t idx = static_cast<int32_t>(g->ids.size());
    id_map.emplace(orig, idx);
    g->ids.push_back(orig);
    adj.emplace_back();
    home.push_back(-1);
    return idx;
  };

  char line[4096];
  char* toks[16];
  while (std::fgets(line, sizeof(line), f)) {
    int n = tokenize(line, toks, 16);
    if (n < 2) continue;
    int64_t so = std::strtoll(toks[0], nullptr, 10);
    int64_t do_ = std::strtoll(toks[1], nullptr, 10);
    float w = 1.0f;
    int pid = -1;
    if (partitioned) {
      if (n > 2) {
        char* end = nullptr;
        long v = std::strtol(toks[2], &end, 10);
        pid = (end != toks[2] && *end == '\0')
                  ? static_cast<int>(v)
                  : static_cast<int>(rng() % num_partitions);
      } else {
        pid = static_cast<int>(rng() % num_partitions);
      }
      if (weighted && n > 3) w = parse_weight_or_one(toks[n - 1]);
    } else {
      if (weighted && n > 2) w = parse_weight_or_one(toks[n - 1]);
    }
    int32_t s = dense(so);
    int32_t d = dense(do_);
    adj[s].emplace_back(d, w);
    if (!directed) adj[d].emplace_back(s, w);
    if (home[s] < 0) home[s] = pid;
    if (home[d] < 0) home[d] = pid;
  }
  std::fclose(f);

  const int64_t V = static_cast<int64_t>(adj.size());
  g->V = V;
  g->offsets.assign(V + 1, 0);
  for (int64_t v = 0; v < V; ++v)
    g->offsets[v + 1] = g->offsets[v] + static_cast<int64_t>(adj[v].size());
  g->E = g->offsets[V];
  g->cols.resize(g->E);
  g->weights.resize(g->E);
  g->alias_prob.resize(g->E);
  g->alias_pos.resize(g->E);
  g->home = std::move(home);

  g->hash_offsets.assign(V + 1, 0);
  g->hash_mask.assign(V, 0);
  std::vector<std::vector<int32_t>> htabs(V);
  for (int64_t v = 0; v < V; ++v) {
    auto& row = adj[v];
    std::stable_sort(row.begin(), row.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    int64_t base = g->offsets[v];
    for (size_t i = 0; i < row.size(); ++i) {
      g->cols[base + i] = row[i].first;
      g->weights[base + i] = row[i].second;
    }
    build_alias_row(g->weights.data() + base, static_cast<int64_t>(row.size()),
                    g->alias_prob.data() + base, g->alias_pos.data() + base);
    if (!row.empty()) {
      build_hash_row(g->cols.data() + base, static_cast<int64_t>(row.size()),
                     htabs[v], g->hash_mask[v]);
    } else {
      htabs[v].assign(8, -1);
      g->hash_mask[v] = 7;
    }
    g->hash_offsets[v + 1] = g->hash_offsets[v] + static_cast<int64_t>(htabs[v].size());
    row.clear();
    row.shrink_to_fit();
  }
  g->H = g->hash_offsets[V];
  g->hash_table.resize(g->H);
  for (int64_t v = 0; v < V; ++v)
    std::memcpy(g->hash_table.data() + g->hash_offsets[v], htabs[v].data(),
                htabs[v].size() * sizeof(int32_t));
  return g;
}

int64_t srw_num_vertices(void* h) { return static_cast<Graph*>(h)->V; }
int64_t srw_num_edges(void* h) { return static_cast<Graph*>(h)->E; }
int64_t srw_hash_size(void* h) { return static_cast<Graph*>(h)->H; }

void srw_copy(void* h, int64_t* ids, int64_t* offsets, int32_t* cols,
              float* weights, float* alias_prob, int32_t* alias_pos,
              int64_t* hash_offsets, int32_t* hash_mask, int32_t* hash_table,
              int32_t* home) {
  auto* g = static_cast<Graph*>(h);
  std::memcpy(ids, g->ids.data(), g->V * sizeof(int64_t));
  std::memcpy(offsets, g->offsets.data(), (g->V + 1) * sizeof(int64_t));
  std::memcpy(cols, g->cols.data(), g->E * sizeof(int32_t));
  std::memcpy(weights, g->weights.data(), g->E * sizeof(float));
  std::memcpy(alias_prob, g->alias_prob.data(), g->E * sizeof(float));
  std::memcpy(alias_pos, g->alias_pos.data(), g->E * sizeof(int32_t));
  std::memcpy(hash_offsets, g->hash_offsets.data(), (g->V + 1) * sizeof(int64_t));
  std::memcpy(hash_mask, g->hash_mask.data(), g->V * sizeof(int32_t));
  std::memcpy(hash_table, g->hash_table.data(), g->H * sizeof(int32_t));
  std::memcpy(home, g->home.data(), g->V * sizeof(int32_t));
}

void srw_free(void* h) { delete static_cast<Graph*>(h); }

// Concatenate row ranges [starts[i], starts[i]+lens[i]) of a flat array into
// dst — the shard-materialization hot loop of graph/partition.py (per-element
// NumPy fancy gathers are ~10x slower than range memcpys at LiveJournal scale).
void srw_gather_rows(const int64_t* starts, const int64_t* lens, int64_t R,
                     const char* src, char* dst, int64_t elem) {
  char* p = dst;
  for (int64_t i = 0; i < R; ++i) {
    const int64_t n = lens[i] * elem;
    std::memcpy(p, src + starts[i] * elem, n);
    p += n;
  }
}

// Standalone per-row hash-table construction over an existing CSR already in
// memory — the fast path for graph/csr.py build_hash_tables (the vectorized
// NumPy build is O(minutes) at 70M arcs; this is O(seconds)). Row layouts are
// bit-identical to the Python builder (same round-based placement as
// build_hash_row). Handle protocol because the total table size is only known
// after construction.
struct HashResult {
  std::vector<int64_t> hoff;
  std::vector<int32_t> hmask;
  std::vector<int32_t> table;
};

void* srw_build_hash(const int64_t* offsets, const int32_t* cols, int64_t V) {
  auto* r = new HashResult;
  r->hoff.assign(V + 1, 0);
  r->hmask.assign(V, 7);
  std::vector<std::vector<int32_t>> tabs(V);
  for (int64_t v = 0; v < V; ++v) {
    const int64_t d = offsets[v + 1] - offsets[v];
    if (d) {
      build_hash_row(cols + offsets[v], d, tabs[v], r->hmask[v]);
    } else {
      tabs[v].assign(8, -1);
      r->hmask[v] = 7;
    }
    r->hoff[v + 1] = r->hoff[v] + static_cast<int64_t>(tabs[v].size());
  }
  r->table.resize(r->hoff[V]);
  for (int64_t v = 0; v < V; ++v)
    std::memcpy(r->table.data() + r->hoff[v], tabs[v].data(),
                tabs[v].size() * sizeof(int32_t));
  return r;
}

int64_t srw_hash_total(void* h) {
  return static_cast<HashResult*>(h)->hoff.back();
}

void srw_hash_copy(void* h, int64_t* hoff, int32_t* hmask, int32_t* table) {
  auto* r = static_cast<HashResult*>(h);
  std::memcpy(hoff, r->hoff.data(), r->hoff.size() * sizeof(int64_t));
  std::memcpy(hmask, r->hmask.data(), r->hmask.size() * sizeof(int32_t));
  std::memcpy(table, r->table.data(), r->table.size() * sizeof(int32_t));
}

void srw_hash_free(void* h) { delete static_cast<HashResult*>(h); }

// Whitespace-separated non-negative-int walks-file parser — the `embedding`
// command's corpus reader (reference Main.scala:119-121 parallelizes this read
// across the Spark cluster; the Python per-token loop costs hours at the
// reference-default corpus). Single pass over the
// byte buffer at memory bandwidth. Digit runs are tokens (any non-digit byte
// separates); empty lines are dropped; a final unterminated line counts.
// Caller protocol: pass 0: out_values == nullptr -> returns token count and
// fills n_lines; pass 1: fills out_values[NT] and out_counts[NL] (tokens per
// non-empty line). Semantics match graph/io._parse_uint_lines exactly,
// including the overflow contract: a token longer than 19 digits cannot be
// represented in int64, so the call returns -1 (the Python wrapper raises
// ValueError, same as the NumPy fallback) instead of silently wrapping.
int64_t srw_parse_walks(const uint8_t* data, int64_t n, int64_t* out_values,
                        int64_t* out_counts, int64_t* n_lines) {
  int64_t nt = 0, nl = 0, line_toks = 0;
  // unsigned accumulate (defined overflow) + explicit INT64_MAX check: a
  // 19-digit token above 2^63-1 must error, never wrap (the >19-digit check
  // alone would let e.g. 9999999999999999999 silently go negative)
  uint64_t cur = 0;
  int digits = 0;
  bool in_tok = false;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = data[i];
    if (c >= '0' && c <= '9') {
      cur = in_tok ? cur * 10 + (c - '0') : uint64_t(c - '0');
      digits = in_tok ? digits + 1 : 1;
      in_tok = true;
      if (digits > 19 || cur > uint64_t(INT64_MAX)) return -1;
    } else {
      if (in_tok) {
        if (out_values) out_values[nt] = int64_t(cur);
        ++nt;
        ++line_toks;
        in_tok = false;
      }
      if (c == '\n' && line_toks) {
        if (out_counts) out_counts[nl] = line_toks;
        ++nl;
        line_toks = 0;
      }
    }
  }
  if (in_tok) {
    if (out_values) out_values[nt] = int64_t(cur);
    ++nt;
    ++line_toks;
  }
  if (line_toks) {
    if (out_counts) out_counts[nl] = line_toks;
    ++nl;
  }
  if (n_lines) *n_lines = nl;
  return nt;
}

// Standalone per-row Vose alias construction over an existing CSR already in
// memory (offsets/weights arrays) — the fast path for graph/csr.py
// build_alias_tables and the word2vec unigram negative table, replacing the
// per-row Python worklist loops (identical pairing order, so output is
// bit-identical to the Python fallback).
void srw_build_alias(const int64_t* offsets, const float* weights, int64_t V,
                     float* prob, int32_t* pos) {
  for (int64_t v = 0; v < V; ++v) {
    const int64_t a = offsets[v];
    build_alias_row(weights + a, offsets[v + 1] - a, prob + a, pos + a);
  }
}

}  // extern "C"
