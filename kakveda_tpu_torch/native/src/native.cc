// kakveda-tpu native host tier, the port's copy.
//
// The card owns the math (the cosine top-k, mining, Llama); this library
// owns three host-side hot loops around it:
//
//   1. hashed n-gram featurization of signature texts — the per-trace CPU
//      cost of the ingest path and of every warn batch;
//   2. an append-only log writer with buffered group-commit — the
//      persistence layer under the GFKB's versioned-append store;
//   3. host-tier scoring (kkv_score_block / kkv_score_candidates /
//      kkv_score_gather) — the sparse-dot cosine over the warm/cold tiers'
//      fixed-width (idx, val) row arrays: the routed match over the rows
//      past the card's hot cap, every degraded-mode warn, and the mining
//      attach of an overflow row. ctypes releases the GIL for each call.
//
// A copy of the JAX package's kakveda_tpu/native/src/native.cc, character
// for character below this header: the port imports nothing of that
// package, and its embeddings and host-tier scores must stay bit-identical
// to the reference's, so the summation orders in encode_one and
// score_range and the compiler flags (kakveda_tpu_torch/native/__init__.py:
// -O3, no -march=native, no -ffast-math) are part of the contract.
//
// Semantics mirror ops/featurizer.py exactly for ASCII text (the Python
// wrapper routes non-ASCII strings to the Python implementation, where
// unicode lowercasing can differ). Hashing is the standard zlib crc32
// polynomial, table-generated here so the library has zero dependencies.
// The L2 norm sums in double, the Python path in float32: the two agree
// to ~1e-7, not bit for bit.
//
// Build: g++ at first use, bound via ctypes from
// kakveda_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(_WIN32)
#error "posix only"
#endif
#include <fcntl.h>
#include <unistd.h>

namespace {

// --- crc32 (zlib polynomial 0xEDB88320, identical to Python zlib.crc32) ---

uint32_t g_crc_table[256];

struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      g_crc_table[i] = c;
    }
  }
} g_crc_init;

uint32_t crc32_buf(const char* buf, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = g_crc_table[(c ^ static_cast<uint8_t>(buf[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// --- featurizer -----------------------------------------------------------

struct FieldSpec {
  std::string name;  // lowercased field label
  float weight;
  bool atomic;
};

// spec string: "name,weight,atomic;name,weight,atomic;..."
std::vector<FieldSpec> parse_spec(const char* spec) {
  std::vector<FieldSpec> out;
  if (!spec) return out;
  const char* p = spec;
  while (*p) {
    const char* end = strchr(p, ';');
    std::string item = end ? std::string(p, end - p) : std::string(p);
    size_t c1 = item.find(',');
    size_t c2 = item.find(',', c1 + 1);
    if (c1 != std::string::npos && c2 != std::string::npos) {
      FieldSpec fs;
      fs.name = item.substr(0, c1);
      fs.weight = strtof(item.c_str() + c1 + 1, nullptr);
      fs.atomic = item[c2 + 1] == '1';
      out.push_back(fs);
    }
    if (!end) break;
    p = end + 1;
  }
  return out;
}

inline bool is_token_char(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

inline char ascii_lower(char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

// Accumulate one hashed term: bucket = crc & 0x7FFFFFFF & (dim-1),
// sign from bit 31 — mirrors featurizer._hash_term / _bucket.
inline void add_term(const char* term, size_t len, float weight, float* row,
                     uint32_t dim_mask) {
  uint32_t h = crc32_buf(term, len);
  float sign = ((h >> 31) & 1u) ? -1.0f : 1.0f;
  row[(h & 0x7FFFFFFFu) & dim_mask] += sign * weight;
}

// Word uni+bigrams of `text` (lowercased, [a-z0-9_]+ tokens), each hashed
// at `weight` — mirrors featurizer._terms. Token emission order matches the
// Python list (all unigrams, then bigrams), which matters for f32
// accumulation order only when buckets collide; we replicate it anyway.
void add_ngrams(const char* text, size_t len, float weight, float* row,
                uint32_t dim_mask, std::string& scratch,
                std::vector<std::pair<size_t, size_t>>& words) {
  scratch.clear();
  scratch.reserve(len);
  for (size_t i = 0; i < len; i++) scratch.push_back(ascii_lower(text[i]));
  words.clear();
  size_t i = 0;
  while (i < scratch.size()) {
    while (i < scratch.size() && !is_token_char(scratch[i])) i++;
    size_t start = i;
    while (i < scratch.size() && is_token_char(scratch[i])) i++;
    if (i > start) words.emplace_back(start, i - start);
  }
  for (auto& w : words) add_term(scratch.data() + w.first, w.second, weight, row, dim_mask);
  std::string gram;
  for (size_t j = 0; j + 1 < words.size(); j++) {
    gram.assign(scratch.data() + words[j].first, words[j].second);
    gram.push_back(' ');
    gram.append(scratch.data() + words[j + 1].first, words[j + 1].second);
    add_term(gram.data(), gram.size(), weight, row, dim_mask);
  }
}

void trim_lower(std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && (s[b] == ' ' || s[b] == '\t' || s[b] == '\n' || s[b] == '\r' ||
                   s[b] == '\f' || s[b] == '\v'))
    b++;
  while (e > b && (s[e - 1] == ' ' || s[e - 1] == '\t' || s[e - 1] == '\n' ||
                   s[e - 1] == '\r' || s[e - 1] == '\f' || s[e - 1] == '\v'))
    e--;
  s = s.substr(b, e - b);
  for (auto& c : s) c = ascii_lower(c);
}

void encode_one(const char* text, int dim, float* row,
                const std::vector<FieldSpec>& specs) {
  const uint32_t dim_mask = static_cast<uint32_t>(dim - 1);
  std::string scratch;
  std::vector<std::pair<size_t, size_t>> words;
  const char* seg = text;
  const char* text_end = text + strlen(text);
  while (seg <= text_end) {
    const char* sep = strstr(seg, " | ");
    const char* seg_end = sep ? sep : text_end;
    // partition on ':'
    const char* colon = static_cast<const char*>(memchr(seg, ':', seg_end - seg));
    const FieldSpec* spec = nullptr;
    if (colon) {
      std::string name(seg, colon - seg);
      std::string key = name;
      trim_lower(key);
      for (auto& fs : specs)
        if (fs.name == key) { spec = &fs; break; }
      if (spec) {
        if (spec->atomic) {
          // each comma item -> single feature "rawname=item"
          const char* p = colon + 1;
          while (p <= seg_end) {
            const char* comma = static_cast<const char*>(memchr(p, ',', seg_end - p));
            const char* item_end = comma ? comma : seg_end;
            std::string item(p, item_end - p);
            trim_lower(item);
            if (!item.empty()) {
              std::string feat = name;  // raw (unstripped) name, as in Python
              feat.push_back('=');
              feat.append(item);
              add_term(feat.data(), feat.size(), spec->weight, row, dim_mask);
            }
            if (!comma) break;
            p = comma + 1;
          }
        } else {
          add_ngrams(colon + 1, seg_end - (colon + 1), spec->weight, row, dim_mask,
                     scratch, words);
        }
      }
    }
    if (!spec) add_ngrams(seg, seg_end - seg, 1.0f, row, dim_mask, scratch, words);
    if (!sep) break;
    seg = sep + 3;
  }
  // L2 normalize (double accumulator; Python's float32 np.linalg.norm agrees
  // to ~1e-7 relative, covered by the parity tests).
  double ss = 0.0;
  for (int j = 0; j < dim; j++) ss += static_cast<double>(row[j]) * row[j];
  if (ss > 0.0) {
    float inv = static_cast<float>(1.0 / std::sqrt(ss));
    for (int j = 0; j < dim; j++) row[j] *= inv;
  }
}

// --- host-tier scoring ----------------------------------------------------

// Score fixed-width sparse rows [r0, r1) against one dense query.
// `qd` has dim+1 floats with qd[dim] == 0.0 (the pad sentinel scores 0);
// any idx outside [0, dim] clamps to the sentinel, so a corrupt row can
// mis-score but never read out of bounds.
inline void score_range(const float* qd, int dim, const int32_t* idx,
                        const float* val, long r0, long r1, int k,
                        float* out) {
  const uint32_t udim = static_cast<uint32_t>(dim);
  for (long r = r0; r < r1; r++) {
    const int32_t* ir = idx + static_cast<size_t>(r) * k;
    const float* vr = val + static_cast<size_t>(r) * k;
    float s = 0.0f;
    for (int j = 0; j < k; j++) {
      uint32_t ix = static_cast<uint32_t>(ir[j]);
      if (ix > udim) ix = udim;  // negatives wrap huge and clamp too
      s += qd[ix] * vr[j];
    }
    out[r] = s;
  }
}

// Split [0, total) into n_threads contiguous chunks and run fn(lo, hi) on
// each; below the spawn floor (or single-threaded) everything runs inline —
// thread startup would dominate small scans.
template <typename Fn>
void parallel_ranges(long total, int n_threads, long spawn_floor, Fn fn) {
  if (n_threads > 64) n_threads = 64;
  if (n_threads <= 1 || total < spawn_floor) {
    fn(0, total);
    return;
  }
  long chunk = (total + n_threads - 1) / n_threads;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    long lo = static_cast<long>(t) * chunk;
    long hi = lo + chunk < total ? lo + chunk : total;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// --- append log -----------------------------------------------------------

struct AppendLog {
  int fd = -1;
  std::mutex mu;
  std::string buf;
  size_t flush_bytes = 1 << 20;
};

}  // namespace

extern "C" {

uint32_t kkv_crc32(const char* buf, int len) { return crc32_buf(buf, len); }

// texts: n NUL-terminated strings; out: [n, dim] float32, caller-zeroed.
// dim must be a power of two. Returns 0 on success.
int kkv_encode_batch(const char** texts, int n, int dim, float* out,
                     const char* spec_str) {
  if (dim <= 0 || (dim & (dim - 1)) != 0) return -1;
  std::vector<FieldSpec> specs = parse_spec(spec_str);
  for (int i = 0; i < n; i++)
    encode_one(texts[i], dim, out + static_cast<size_t>(i) * dim, specs);
  return 0;
}

// Sparse encode: same features as kkv_encode_batch, emitted as (idx, val)
// pairs for the device-side scatter-add (hashed rows are ~98% zeros, so the
// dense [n, dim] form wastes host→device bandwidth). idx: [n, k] caller-
// filled with `dim` (the scatter drop sentinel); val: [n, k] caller-zeroed.
// Returns 0 on success, or the required k when some row has more than k
// nonzeros (caller re-allocs and retries), or -1 on bad dim.
int kkv_encode_sparse_batch(const char** texts, int n, int dim, int k,
                            int32_t* idx, float* val, const char* spec_str) {
  if (dim <= 0 || (dim & (dim - 1)) != 0) return -1;
  std::vector<FieldSpec> specs = parse_spec(spec_str);
  std::vector<float> row(static_cast<size_t>(dim));
  int need = 0;
  for (int i = 0; i < n; i++) {
    std::memset(row.data(), 0, sizeof(float) * dim);
    encode_one(texts[i], dim, row.data(), specs);
    int m = 0;
    int32_t* irow = idx + static_cast<size_t>(i) * k;
    float* vrow = val + static_cast<size_t>(i) * k;
    for (int j = 0; j < dim; j++) {
      if (row[j] != 0.0f) {
        if (m < k) {
          irow[m] = j;
          vrow[m] = row[j];
        }
        m++;
      }
    }
    if (m > need) need = m;
  }
  return need > k ? need : 0;
}

// Host-tier block scorer: b dense queries ([b, dim+1] f32, qd[dim] == 0)
// against the SAME n fixed-width sparse rows (idx [n, k] int32 with pad ==
// dim, val [n, k] f32). out: [b, n] f32. The one-query case (b == 1) is the
// warm/cold exact scan; b > 1 is the degraded-window warn batch — every
// query streams the row block once. Returns 0 on success, -1 on bad args.
int kkv_score_block(const float* qdense, long b, int dim, const int32_t* idx,
                    const float* val, long n, int k, float* out,
                    int n_threads) {
  if (!qdense || !out || b < 0 || n < 0 || dim <= 0 || k < 0) return -1;
  if (n > 0 && k > 0 && (!idx || !val)) return -1;
  if (k == 0 || n == 0) {
    std::memset(out, 0, sizeof(float) * static_cast<size_t>(b) * n);
    return 0;
  }
  parallel_ranges(n, n_threads, 1 << 14, [=](long lo, long hi) {
    for (long q = 0; q < b; q++)
      score_range(qdense + static_cast<size_t>(q) * (dim + 1), dim, idx, val,
                  lo, hi, k, out + static_cast<size_t>(q) * n);
  });
  return 0;
}

// Thread-pooled IVF candidate scorer: query q scores the concatenated
// candidate rows [offsets[q], offsets[q+1]) — ONE call per match batch for
// degraded warn, overflow routed matching and the mining attach path.
// qdense: [b, dim+1]; idx/val: [offsets[b], k]; out: [offsets[b]] f32.
// Returns 0 on success, -1 on bad args (incl. non-monotonic offsets).
int kkv_score_candidates(const float* qdense, long b, int dim,
                         const int32_t* idx, const float* val,
                         const int64_t* offsets, int k, float* out,
                         int n_threads) {
  if (!qdense || !offsets || b < 0 || dim <= 0 || k < 0) return -1;
  long total = static_cast<long>(offsets[b]);
  if (offsets[0] != 0 || total < 0) return -1;
  for (long q = 0; q < b; q++)
    if (offsets[q + 1] < offsets[q]) return -1;
  if (total == 0) return 0;
  if (!out || (k > 0 && (!idx || !val))) return -1;
  if (k == 0) {
    std::memset(out, 0, sizeof(float) * static_cast<size_t>(total));
    return 0;
  }
  // Chunk the FLAT row range so one giant candidate list still splits
  // across threads; each chunk walks the queries overlapping it.
  parallel_ranges(total, n_threads, 1 << 14, [=](long lo, long hi) {
    long q = 0;
    while (q < b && static_cast<long>(offsets[q + 1]) <= lo) q++;
    for (; q < b && static_cast<long>(offsets[q]) < hi; q++) {
      long r0 = static_cast<long>(offsets[q]) > lo
                    ? static_cast<long>(offsets[q]) : lo;
      long r1 = static_cast<long>(offsets[q + 1]) < hi
                    ? static_cast<long>(offsets[q + 1]) : hi;
      score_range(qdense + static_cast<size_t>(q) * (dim + 1), dim, idx, val,
                  r0, r1, k, out);
    }
  });
  return 0;
}

// Gather-scorer: score row ids straight out of a resident base array
// (warm tier) or an mmap'd cold shard — no [m, k] materialization, no
// Python-side fancy-index copy; cold pages fault in during the scan with
// the GIL released. qdense: [dim+1] (one query); idx/val: the base
// arrays, row stride k; rows: [m] int64 row ids into the base. out: [m].
// The CALLER guarantees row ids are in range — this is the hot path and
// it does no bounds checking beyond the per-entry feature clamp.
int kkv_score_gather(const float* qdense, int dim, const int32_t* idx,
                     const float* val, int k, const int64_t* rows, long m,
                     float* out, int n_threads) {
  if (!qdense || !out || m < 0 || dim <= 0 || k < 0) return -1;
  if (m == 0) return 0;
  if (!rows) return -1;
  if (k == 0 || !idx || !val) {
    std::memset(out, 0, sizeof(float) * static_cast<size_t>(m));
    return 0;
  }
  const uint32_t udim = static_cast<uint32_t>(dim);
  parallel_ranges(m, n_threads, 1 << 14, [=](long lo, long hi) {
    // The row indirection defeats the hardware prefetcher (each row is a
    // ~128 B island in a multi-GB mmap) — software-prefetch a few rows
    // ahead so the memory latency overlaps the current row's math.
    constexpr long kPrefetch = 8;
    for (long i = lo; i < hi; i++) {
      if (i + kPrefetch < hi) {
        const size_t pr = static_cast<size_t>(rows[i + kPrefetch]);
        __builtin_prefetch(idx + pr * k, 0, 1);
        __builtin_prefetch(val + pr * k, 0, 1);
      }
      const size_t row = static_cast<size_t>(rows[i]);
      const int32_t* ir = idx + row * k;
      const float* vr = val + row * k;
      float s = 0.0f;
      for (int j = 0; j < k; j++) {
        uint32_t ix = static_cast<uint32_t>(ir[j]);
        if (ix > udim) ix = udim;  // pad and negatives clamp to the zero slot
        s += qdense[ix] * vr[j];
      }
      out[i] = s;
    }
  });
  return 0;
}

// Append-only log: open(append mode) -> handle.
void* kkv_log_open(const char* path, long flush_bytes) {
  int fd = open(path, O_WRONLY | O_APPEND | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  auto* log = new AppendLog();
  log->fd = fd;
  if (flush_bytes > 0) log->flush_bytes = static_cast<size_t>(flush_bytes);
  return log;
}

// Buffered append; flushes to the kernel when the buffer tops flush_bytes.
// One record = caller's bytes (caller includes the trailing newline).
int kkv_log_append(void* h, const char* data, long len) {
  auto* log = static_cast<AppendLog*>(h);
  if (!log || log->fd < 0 || len < 0) return -1;
  std::lock_guard<std::mutex> lk(log->mu);
  log->buf.append(data, static_cast<size_t>(len));
  if (log->buf.size() >= log->flush_bytes) {
    ssize_t n = write(log->fd, log->buf.data(), log->buf.size());
    if (n != static_cast<ssize_t>(log->buf.size())) return -1;
    log->buf.clear();
  }
  return 0;
}

// Drain the buffer to the kernel; fsync when do_fsync != 0 (group commit:
// many appends, one durability point).
int kkv_log_flush(void* h, int do_fsync) {
  auto* log = static_cast<AppendLog*>(h);
  if (!log || log->fd < 0) return -1;
  std::lock_guard<std::mutex> lk(log->mu);
  if (!log->buf.empty()) {
    ssize_t n = write(log->fd, log->buf.data(), log->buf.size());
    if (n != static_cast<ssize_t>(log->buf.size())) return -1;
    log->buf.clear();
  }
  if (do_fsync && fsync(log->fd) != 0) return -1;
  return 0;
}

void kkv_log_close(void* h) {
  auto* log = static_cast<AppendLog*>(h);
  if (!log) return;
  kkv_log_flush(h, 0);
  close(log->fd);
  delete log;
}

}  // extern "C"
