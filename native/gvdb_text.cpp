// gvdb_text — native BM25 tokenizer hot loop (ASCII fast path).
//
// The write-path profile puts per-document tokenization + term counting among
// the top Python costs of `batch_add_documents` (docs/benchmarks.md serving
// section). This implements EXACTLY the SimpleTokenizer semantics for
// pure-ASCII text (engine/sparse.py): lowercase [a-z0-9_]+ runs, English
// stopword removal, term -> count map. Non-ASCII text falls back to the
// Python path on the binding side (Unicode lowercasing and the CJK scan stay
// single-sourced in Python), so the two implementations can never disagree on
// the inputs this one accepts.
//
// C ABI (ctypes; pybind11 is not in this image):
//   gvdb_tokenize_counts(text, len, out, cap, &total) -> n_unique | -needed
// Output records: [u16 token_len][token bytes][u32 count], tightly packed.

#include <algorithm>
#include <array>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const std::unordered_set<std::string>& stopwords() {
    // keep in lockstep with engine/sparse.py::_EN_STOPWORDS
    static const std::unordered_set<std::string> s = {
        "a", "an", "and", "are", "as", "at", "be", "by", "for", "from",
        "has", "he", "in", "is", "it", "its", "of", "on", "that", "the",
        "to", "was", "were", "will", "with", "this", "but", "they", "have",
        "had", "what", "when", "where", "who", "which", "why", "how", "or",
        "not", "no", "so", "if", "than", "then",
    };
    return s;
}

}  // namespace

extern "C" {

// Tokenize ASCII text; returns the number of unique terms written to `out`,
// or -(bytes needed) when `cap` is too small (caller retries with a bigger
// buffer). `total` receives the total token count (BM25 doc length).
int32_t gvdb_tokenize_counts(const char* text, int32_t n, char* out,
                             int32_t cap, int32_t* total) {
    const auto& stop = stopwords();
    std::unordered_map<std::string, uint32_t> counts;
    counts.reserve(64);
    int32_t tot = 0;
    std::string tok;
    tok.reserve(24);
    for (int32_t i = 0; i <= n; ++i) {
        char c = (i < n) ? text[i] : ' ';
        if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
        const bool in_token =
            (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
        if (in_token) {
            tok.push_back(c);
            continue;
        }
        if (!tok.empty()) {
            if (stop.find(tok) == stop.end()) {
                ++counts[tok];
                ++tot;
            }
            tok.clear();
        }
    }
    int64_t need = 0;
    for (const auto& kv : counts) {
        if (kv.first.size() > 0xFFFF) {
            // token exceeds the u16 record header — signal the binding to
            // fall back to the Python path (INT32_MIN sentinel)
            return INT32_MIN;
        }
        need += 2 + static_cast<int64_t>(kv.first.size()) + 4;
    }
    if (need > cap) return static_cast<int32_t>(-need);
    char* p = out;
    for (const auto& kv : counts) {
        const uint16_t l = static_cast<uint16_t>(kv.first.size());
        std::memcpy(p, &l, 2);
        p += 2;
        std::memcpy(p, kv.first.data(), l);
        p += l;
        const uint32_t cnum = kv.second;
        std::memcpy(p, &cnum, 4);
        p += 4;
    }
    if (total != nullptr) *total = tot;
    return static_cast<int32_t>(counts.size());
}

// Batch tokenizer: n_docs ASCII texts in ONE call (the write path calls this
// once per ingest batch instead of once per document — ctypes call + buffer
// overhead was ~1/3 of the sparse ingest profile).
//
// Inputs: concatenated text bytes + offsets[n_docs+1].
// Outputs:
//   term_table: packed [u16 len][bytes] records, one per UNIQUE term in the
//       batch, in first-seen order; *n_terms receives the count.
//   pair_doc / pair_term / pair_count: parallel i32 arrays, one entry per
//       (document, unique-term) pair; pair_term indexes the term table.
//   doc_total: per-document total token count (BM25 doc length).
// Returns the number of pairs written; on insufficient capacity returns -1
// with *need_terms / *need_pairs set to the required sizes (caller retries);
// returns INT32_MIN when a token exceeds the u16 record header (caller falls
// back to the Python path).
int32_t gvdb_tokenize_batch(const char* texts, const int32_t* offsets,
                            int32_t n_docs, char* term_table,
                            int32_t term_cap, int32_t* n_terms,
                            int32_t* pair_doc, int32_t* pair_term,
                            int32_t* pair_count, int32_t pair_cap,
                            int32_t* doc_total, int64_t* need_terms,
                            int64_t* need_pairs) {
    // char-class + lowercase table: one load per input byte replaces three
    // range compares and a branchy lowercase
    static const unsigned char* kCls = [] {
        static unsigned char t[256] = {0};
        for (int c = 'a'; c <= 'z'; ++c) t[c] = static_cast<unsigned char>(c);
        for (int c = 'A'; c <= 'Z'; ++c)
            t[c] = static_cast<unsigned char>(c - 'A' + 'a');
        for (int c = '0'; c <= '9'; ++c) t[c] = static_cast<unsigned char>(c);
        t[static_cast<unsigned char>('_')] = '_';
        return t;
    }();
    // ONE hash per token: the term map is pre-seeded with stopwords at
    // tid = -1 (the old form hashed every token twice — stopword set, then
    // term map)
    std::unordered_map<std::string, int32_t> term_ids;
    term_ids.reserve(4096);
    for (const auto& s : stopwords()) term_ids.emplace(s, -1);
    std::vector<std::string> terms;
    terms.reserve(1024);
    std::vector<int32_t> p_doc, p_term, p_count;
    p_doc.reserve(static_cast<size_t>(n_docs) * 8);
    p_term.reserve(static_cast<size_t>(n_docs) * 8);
    p_count.reserve(static_cast<size_t>(n_docs) * 8);

    // per-doc counts as a flat tid-indexed array + touched list: the old
    // per-doc unordered_map paid node allocs and a bucket walk per clear()
    std::vector<uint32_t> cnt;
    std::vector<int32_t> touched;
    touched.reserve(64);
    std::string tok;
    tok.reserve(24);
    for (int32_t d = 0; d < n_docs; ++d) {
        int32_t tot = 0;
        const int32_t beg = offsets[d], end = offsets[d + 1];
        for (int32_t i = beg; i <= end; ++i) {
            const unsigned char m =
                (i < end) ? kCls[static_cast<unsigned char>(texts[i])] : 0;
            if (m != 0) {
                tok.push_back(static_cast<char>(m));
                continue;
            }
            if (!tok.empty()) {
                if (tok.size() > 0xFFFF) return INT32_MIN;
                auto ins = term_ids.try_emplace(tok, 0);
                int32_t tid;
                if (ins.second) {
                    tid = static_cast<int32_t>(terms.size());
                    ins.first->second = tid;
                    terms.push_back(tok);
                    cnt.push_back(0);
                } else {
                    tid = ins.first->second;
                }
                if (tid >= 0) {
                    if (cnt[static_cast<size_t>(tid)]++ == 0)
                        touched.push_back(tid);
                    ++tot;
                }
                tok.clear();
            }
        }
        doc_total[d] = tot;
        for (const int32_t tid : touched) {
            p_doc.push_back(d);
            p_term.push_back(tid);
            p_count.push_back(static_cast<int32_t>(cnt[static_cast<size_t>(tid)]));
            cnt[static_cast<size_t>(tid)] = 0;
        }
        touched.clear();
    }

    int64_t tneed = 0;
    for (const auto& t : terms) tneed += 2 + static_cast<int64_t>(t.size());
    const int64_t pneed = static_cast<int64_t>(p_doc.size());
    if (tneed > term_cap || pneed > pair_cap) {
        *need_terms = tneed;
        *need_pairs = pneed;
        return -1;
    }
    char* p = term_table;
    for (const auto& t : terms) {
        const uint16_t l = static_cast<uint16_t>(t.size());
        std::memcpy(p, &l, 2);
        p += 2;
        std::memcpy(p, t.data(), l);
        p += l;
    }
    *n_terms = static_cast<int32_t>(terms.size());
    if (pneed > 0) {
        std::memcpy(pair_doc, p_doc.data(), pneed * 4);
        std::memcpy(pair_term, p_term.data(), pneed * 4);
        std::memcpy(pair_count, p_count.data(), pneed * 4);
    }
    return static_cast<int32_t>(pneed);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// gvdb_hash_features — native hot loop for services/device_embedder.py.
//
// The Python featurizer (_features) is a pure-Python char n-gram loop with
// a zlib.crc32 per feature, which caps embedding-at-ingest. This reproduces it EXACTLY for ASCII text: SimpleTokenizer ASCII
// semantics (same loop as above), features = token + char n-grams of
// "<token>" for n in [lo_n, hi_n], key = crc32(feat + salt) % buckets with
// the sign bit from crc32("#" + feat + salt) & 1 (signed-key encoding:
// +b / -(b+1)), per-key occurrence counts, log1p damping, top-m by
// (-count, key). Non-ASCII texts stay on the Python path (binding side).

namespace {

const uint32_t* crc32_table() {
    // magic-static init: concurrent first calls (pipelined ingest runs the
    // featurizer from two threads) must not race the table fill
    static const auto t = [] {
        std::array<uint32_t, 256> a{};
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1u) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
            a[i] = c;
        }
        return a;
    }();
    return t.data();
}

// zlib-compatible: crc32(b) == crc32_update(0, b); incremental over concat.
inline uint32_t crc32_update(uint32_t crc, const char* buf, size_t len) {
    const uint32_t* t = crc32_table();
    crc ^= 0xFFFFFFFFu;
    for (size_t i = 0; i < len; ++i)
        crc = t[(crc ^ static_cast<uint8_t>(buf[i])) & 0xFFu] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// Token-level feature memoization: a token's feature multiset (the token +
// its char n-grams, each mapped to a signed bucket key) depends only on the
// token and the (salt, lo_n, hi_n, buckets) config — NOT on the document.
// Real corpora are Zipf-distributed, so almost every token instance repeats
// an already-seen token; caching the per-token (key, multiplicity) list
// skips all crc32 work for it and turns the per-doc cost into map merges.
// This is the embed-at-ingest throughput lever on a 1-core host where
// threading the featurizer buys nothing. Bit-exact: the doc accumulator is
// sum over unique tokens of count(t) * multiset(t), identical to the
// feature-at-a-time accumulation it replaces.
struct TokenFeatCache {
    std::string salt;
    int32_t lo_n = -1, hi_n = -1, buckets = -1;
    std::unordered_map<std::string,
                       std::vector<std::pair<int32_t, int32_t>>> map;
};

TokenFeatCache& token_cache() {
    static TokenFeatCache c;
    return c;
}

std::mutex& token_cache_mu() {
    static std::mutex mu;
    return mu;
}

// Soft bound: ~2M cached tokens (~200 MB worst case). Clearing on overflow
// keeps the amortized cost at one recompute per token per epoch.
constexpr size_t kMaxCachedTokens = 2'000'000;

}  // namespace

extern "C" {

// Returns 0 on success. out_idx/out_val are [n_docs * m], caller-zeroed.
int32_t gvdb_hash_features(
    const char* texts, const int32_t* offsets, int32_t n_docs,
    const char* salt, int32_t salt_len,
    int32_t lo_n, int32_t hi_n, int32_t buckets, int32_t m,
    int32_t* out_idx, float* out_val) {
    if (buckets <= 0 || m <= 0) return -1;
    const auto& stop = stopwords();
    const uint32_t hash_salt = crc32_update(0, "#", 1);
    std::unordered_map<std::string, uint32_t> counts;
    std::unordered_map<int64_t, int64_t> acc;
    std::vector<std::pair<int64_t, int64_t>> items;
    std::string tok, padded;
    counts.reserve(128);
    acc.reserve(2048);
    tok.reserve(24);
    // one lock for the whole call: ctypes releases the GIL around foreign
    // calls, so concurrent embedders could otherwise race the static cache
    std::lock_guard<std::mutex> cache_lock(token_cache_mu());
    TokenFeatCache& tc = token_cache();
    if (tc.lo_n != lo_n || tc.hi_n != hi_n || tc.buckets != buckets ||
        tc.salt.size() != static_cast<size_t>(salt_len) ||
        std::memcmp(tc.salt.data(), salt, static_cast<size_t>(salt_len)) != 0) {
        tc.map.clear();
        tc.salt.assign(salt, static_cast<size_t>(salt_len));
        tc.lo_n = lo_n;
        tc.hi_n = hi_n;
        tc.buckets = buckets;
    }
    std::unordered_map<int32_t, int32_t> tok_acc;
    tok_acc.reserve(256);
    for (int32_t d = 0; d < n_docs; ++d) {
        counts.clear();
        acc.clear();
        const char* text = texts + offsets[d];
        const int32_t n = offsets[d + 1] - offsets[d];
        for (int32_t i = 0; i <= n; ++i) {
            char c = (i < n) ? text[i] : ' ';
            if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
            const bool in_token =
                (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
            if (in_token) {
                tok.push_back(c);
                continue;
            }
            if (!tok.empty()) {
                if (stop.find(tok) == stop.end()) ++counts[tok];
                tok.clear();
            }
        }
        for (const auto& kv : counts) {
            const std::string& t = kv.first;
            const int64_t cnt = kv.second;
            auto hit = tc.map.find(t);
            if (hit == tc.map.end()) {
                // novel token: compute its feature multiset once and cache
                // it as a (signed key, multiplicity) list
                tok_acc.clear();
                padded.clear();
                padded.push_back('<');
                padded += t;
                padded.push_back('>');
                // feature -> signed key, for the token itself and every
                // char n-gram of the padded form
                auto add_feat = [&](const char* f, size_t flen) {
                    const uint32_t c_f = crc32_update(0, f, flen);
                    const uint32_t c_raw = crc32_update(
                        c_f, salt, static_cast<size_t>(salt_len));
                    const int32_t b = static_cast<int32_t>(
                        c_raw % static_cast<uint32_t>(buckets));
                    const uint32_t c_sign = crc32_update(
                        crc32_update(hash_salt, f, flen), salt,
                        static_cast<size_t>(salt_len));
                    const int32_t key = (c_sign & 1u) ? b : -(b + 1);
                    ++tok_acc[key];
                };
                add_feat(t.data(), t.size());
                const int64_t plen = static_cast<int64_t>(padded.size());
                for (int32_t ng = lo_n; ng <= hi_n; ++ng) {
                    if (plen < ng) break;
                    for (int64_t i = 0; i + ng <= plen; ++i)
                        add_feat(padded.data() + i, static_cast<size_t>(ng));
                }
                if (tc.map.size() >= kMaxCachedTokens) tc.map.clear();
                hit = tc.map.emplace(
                    t, std::vector<std::pair<int32_t, int32_t>>(
                           tok_acc.begin(), tok_acc.end())).first;
            }
            for (const auto& km : hit->second)
                acc[km.first] += static_cast<int64_t>(km.second) * cnt;
        }
        if (acc.empty()) continue;
        items.assign(acc.begin(), acc.end());
        std::sort(items.begin(), items.end(),
                  [](const std::pair<int64_t, int64_t>& a,
                     const std::pair<int64_t, int64_t>& b) {
                      if (a.second != b.second) return a.second > b.second;
                      return a.first < b.first;
                  });
        const size_t take = items.size() < static_cast<size_t>(m)
                                ? items.size() : static_cast<size_t>(m);
        int32_t* oi = out_idx + static_cast<int64_t>(d) * m;
        float* ov = out_val + static_cast<int64_t>(d) * m;
        for (size_t j = 0; j < take; ++j) {
            const int64_t key = items[j].first;
            const float w = static_cast<float>(
                std::log1p(static_cast<double>(items[j].second)));
            if (key >= 0) {
                oi[j] = static_cast<int32_t>(key);
                ov[j] = w;
            } else {
                oi[j] = static_cast<int32_t>(-key - 1);
                ov[j] = -w;
            }
        }
    }
    return 0;
}

}  // extern "C"
