// Corpus ingestion: whitespace tokenization + unique-word dedup with counts.
//
// Behavior contract from the reference (derived, not copied):
//   * delimiters {' ', '\t', '\r', '\n'} — bpe_load_corpus strtok set,
//     /root/reference/shredword/csrc/bpe/bpe.cpp:247
//   * dedup to unique words weighted by occurrence count — bpe.cpp:213-252
//   * faithful word order = StrMap iteration order: djb2 hash & 4095
//     buckets, first-touch order within a bucket — hash.cpp:29-53, 61-72
//
// The fast path is new: threaded chunk scan + per-thread hash maps merged
// deterministically, with canonical (count desc, bytes asc) ordering.

#include "shred_native.hpp"

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <thread>
#include <unordered_map>

namespace shred {

uint64_t Corpus::unique_bytes() const {
  uint64_t n = 0;
  for (const auto& w : words) n += w.size();
  return n;
}

uint64_t fnv1a64(const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < len; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

static inline bool is_delim(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

// djb2 over a NUL-free byte string (reference strmap_increment hash,
// hash.cpp:34-38).
static inline size_t djb2(const uint8_t* s, size_t len) {
  size_t h = 5381;
  for (size_t i = 0; i < len; i++) h = ((h << 5) + h) + s[i];
  return h;
}

int auto_threads(int nthreads) {
  if (nthreads > 0) return nthreads;
  int hc = (int)std::thread::hardware_concurrency();
  int n = hc - 2;  // leave headroom (policy of reference threads.cpp:13-24)
  return n < 1 ? 1 : n;
}

namespace {
struct WordStat {
  uint64_t count = 0;
  uint64_t first_touch = 0;  // global first-occurrence rank (for ordering)
};
using WordMap = std::unordered_map<std::string, WordStat>;

// Scan [begin, end) of data, but start at the first token that *begins*
// inside the range (a token straddling `begin` belongs to the previous
// chunk) and finish the token straddling `end`.  `base` offsets
// first_touch so streamed blocks keep a GLOBAL first-occurrence rank.
void scan_chunk(const uint8_t* data, int64_t len, int64_t begin, int64_t end,
                int64_t base, WordMap* out, uint64_t* n_occurrences) {
  int64_t i = begin;
  if (begin > 0 && !is_delim(data[begin - 1])) {
    while (i < end && !is_delim(data[i])) i++;  // skip partial token
  }
  uint64_t occ = 0;
  while (i < end) {
    while (i < end && is_delim(data[i])) i++;
    if (i >= end) break;
    int64_t start = i;
    while (i < len && !is_delim(data[i])) i++;  // may run past `end`
    auto& st = (*out)[std::string((const char*)data + start, i - start)];
    if (st.count == 0) st.first_touch = (uint64_t)(base + start);
    st.count++;
    occ++;
  }
  *n_occurrences += occ;
}

// Threaded scan of one in-memory block, merged into a persistent map
// (the streaming loader calls this once per block).
void scan_block_into(const uint8_t* data, int64_t len, int64_t base,
                     int nthreads, WordMap* merged, uint64_t* occ_total) {
  int nt = auto_threads(nthreads);
  if ((int64_t)nt > len / (1 << 16))
    nt = (int)std::max<int64_t>(1, len / (1 << 16));

  std::vector<WordMap> maps(nt);
  std::vector<uint64_t> occs(nt, 0);
  if (nt == 1) {
    scan_chunk(data, len, 0, len, base, &maps[0], &occs[0]);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = len / nt;
    for (int t = 0; t < nt; t++) {
      int64_t b = t * chunk;
      int64_t e = (t == nt - 1) ? len : (t + 1) * chunk;
      threads.emplace_back(scan_chunk, data, len, b, e, base, &maps[t],
                           &occs[t]);
    }
    for (auto& th : threads) th.join();
  }
  for (int t = 0; t < nt; t++) {
    for (auto& kv : maps[t]) {
      auto& st = (*merged)[kv.first];
      if (st.count == 0) {
        st = kv.second;
      } else {
        st.count += kv.second.count;
        st.first_touch = std::min(st.first_touch, kv.second.first_touch);
      }
    }
    *occ_total += occs[t];
  }
}

// Ordering + row extraction shared by the whole-buffer and streaming
// loaders.
Corpus finalize_corpus(WordMap&& merged, uint64_t total_bytes,
                       uint64_t total_occ, bool faithful_order) {
  Corpus corpus;
  corpus.total_raw_bytes = total_bytes;
  corpus.total_word_occurrences = total_occ;

  struct Row {
    const std::string* word;
    uint64_t count, first_touch;
  };
  std::vector<Row> rows;
  rows.reserve(merged.size());
  for (auto& kv : merged)
    rows.push_back({&kv.first, kv.second.count, kv.second.first_touch});

  if (faithful_order) {
    // Reference StrMap order: bucket = djb2 & (4096-1) ascending; within a
    // bucket, chains append at the tail so iteration order is first-touch
    // order (hash.cpp:40-52 walk-to-end insert; strmap_iter head->tail).
    std::stable_sort(rows.begin(), rows.end(), [](const Row& x, const Row& y) {
      size_t bx = djb2((const uint8_t*)x.word->data(), x.word->size()) & 4095;
      size_t by = djb2((const uint8_t*)y.word->data(), y.word->size()) & 4095;
      if (bx != by) return bx < by;
      return x.first_touch < y.first_touch;
    });
  } else {
    // Canonical deterministic order for the device path.
    std::stable_sort(rows.begin(), rows.end(), [](const Row& x, const Row& y) {
      if (x.count != y.count) return x.count > y.count;
      return *x.word < *y.word;
    });
  }

  corpus.words.reserve(rows.size());
  corpus.counts.reserve(rows.size());
  for (auto& r : rows) {
    corpus.words.push_back(*r.word);
    corpus.counts.push_back(r.count);
  }
  return corpus;
}
}  // namespace

Corpus build_corpus(const uint8_t* data, int64_t len, bool faithful_order,
                    int nthreads) {
  WordMap merged;
  uint64_t occ = 0;
  scan_block_into(data, len, 0, nthreads, &merged, &occ);
  return finalize_corpus(std::move(merged), (uint64_t)len, occ,
                         faithful_order);
}

namespace {
Corpus stream_from(FILE* fp, bool faithful_order, int nthreads,
                   int64_t block_bytes, bool* ok);
}  // namespace

Corpus build_corpus_streaming(const char* path, bool faithful_order,
                              int nthreads, int64_t block_bytes, bool* ok) {
  *ok = false;
  Corpus corpus;
  FILE* fp = fopen(path, "rb");
  if (!fp) return corpus;
  return stream_from(fp, faithful_order, nthreads, block_bytes, ok);
}

namespace {
// Bounded-memory ingestion from an ALREADY-OPEN stream (takes
// ownership): the file is read in blocks; only the unique-word map
// persists.  A token straddling a block boundary is carried to the
// front of the next block, so the word stream (and the faithful
// first-touch order, via global base offsets) is identical to the
// whole-buffer loader's.  Accepting the open handle matters for
// FIFOs/pipes: a close-reopen gap would leave the writer reader-less
// (SIGPIPE).
Corpus stream_from(FILE* fp, bool faithful_order, int nthreads,
                   int64_t block_bytes, bool* ok) {
  *ok = false;
  Corpus corpus;
  if (block_bytes < (1 << 12)) block_bytes = (1 << 12);
  std::vector<uint8_t> buf;
  buf.reserve((size_t)block_bytes + 4096);
  WordMap merged;
  uint64_t occ = 0, total_bytes = 0;
  int64_t base = 0;           // global offset of buf[0]
  size_t carry = 0;           // partial-token bytes kept from last block
  for (;;) {
    buf.resize(carry + (size_t)block_bytes);
    size_t got = fread(buf.data() + carry, 1, (size_t)block_bytes, fp);
    total_bytes += got;
    size_t have = carry + got;
    buf.resize(have);
    if (have == 0) break;
    bool eof = got < (size_t)block_bytes;
    size_t scan_end = have;
    if (!eof) {
      // hold back the trailing partial token for the next block
      while (scan_end > 0 && !is_delim(buf[scan_end - 1])) scan_end--;
      if (scan_end == 0) {
        // one token larger than the whole block: grow the block
        carry = have;
        block_bytes *= 2;
        continue;
      }
    }
    scan_block_into(buf.data(), (int64_t)scan_end, base, nthreads,
                    &merged, &occ);
    if (eof) break;
    carry = have - scan_end;
    std::memmove(buf.data(), buf.data() + scan_end, carry);
    base += (int64_t)scan_end;
  }
  fclose(fp);
  *ok = true;
  return finalize_corpus(std::move(merged), total_bytes, occ,
                         faithful_order);
}
}  // namespace

Corpus build_corpus_from_file(const char* path, bool faithful_order,
                              int nthreads, bool* ok) {
  *ok = false;
  Corpus corpus;
  FILE* fp = fopen(path, "rb");
  if (!fp) return corpus;
  fseek(fp, 0, SEEK_END);
  long len = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  // Large files stream with bounded memory instead of one giant buffer;
  // unseekable inputs (pipes, /dev/stdin: ftell < 0) must stream too —
  // from THIS handle (no close-reopen: a FIFO writer would get SIGPIPE
  // in the gap).
  const int64_t kStreamThreshold = 1LL << 31;   // 2 GiB
  if (len < 0 || (int64_t)len > kStreamThreshold)
    return stream_from(fp, faithful_order, nthreads, 1LL << 28, ok);
  std::vector<uint8_t> buf((size_t)len);
  if (len > 0 && fread(buf.data(), 1, (size_t)len, fp) != (size_t)len) {
    fclose(fp);
    return corpus;
  }
  fclose(fp);
  *ok = true;
  return build_corpus(buf.data(), len, faithful_order, nthreads);
}

// ---------------------------------------------------------------------------
// Character coverage (reference bpe_load_corpus steps 2-3, bpe.cpp:256-279):
//   * per-byte histogram counting each byte once per unique-word occurrence
//     of that byte (char_hist counts every byte position of every unique
//     word with weight 1, histogram.cpp:30-36)
//   * iteration order of the char map: single-byte djb2 & 255 =
//     (165 + byte) & 255 ascending (each byte its own bucket)
//   * stable sort descending by count (glibc qsort is mergesort => stable)
//   * keep = floor(n_unique * float(coverage)) most frequent
// ---------------------------------------------------------------------------
CoverageResult compute_coverage(const Corpus& corpus, double coverage) {
  uint64_t hist[256] = {0};
  for (const auto& w : corpus.words)
    for (unsigned char c : w) hist[c]++;

  struct CC {
    uint8_t c;
    uint64_t count;
  };
  std::vector<CC> cc;
  for (int slot = 0; slot < 256; slot++) {
    // bucket index b = (165 + c) & 255  =>  c = (b - 165) & 255
    uint8_t c = (uint8_t)((slot - 165) & 255);
    if (hist[c] > 0) cc.push_back({c, hist[c]});
  }
  std::stable_sort(cc.begin(), cc.end(),
                   [](const CC& x, const CC& y) { return x.count > y.count; });

  CoverageResult res;
  std::memset(res.keep, 0, sizeof(res.keep));
  res.n_unique = (int)cc.size();
  // reference computes keep with float arithmetic: (size_t)(c * coverage_f)
  float cov_f = (float)coverage;
  size_t keep = (size_t)((float)cc.size() * cov_f);
  if (keep > cc.size()) keep = cc.size();
  res.n_kept = (int)keep;
  for (size_t i = 0; i < keep; i++) res.keep[cc[i].c] = true;
  return res;
}

}  // namespace shred
