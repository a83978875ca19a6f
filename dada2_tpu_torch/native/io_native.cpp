// Native host data-loader: streaming fastq(.gz) parsing + dereplication.
//
// The host-side stage that feeds padded unique-sequence batches to the
// device (the equivalent of the reference's ShortRead::FastqStreamer +
// qtables2 pipeline, R/sequenceIO.R:45-183). Implements EXACTLY the same
// semantics as dada2_tpu_torch/derep.py (which remains the pure-Python
// fallback): reads are processed in chunks; within a chunk uniques are
// discovered in lexical order (stable by read index); across chunks new
// uniques append in encounter order; per-chunk quality sums are
// accumulated per unique and then merged chunk-by-chunk (float64, same
// association order as the Python path, so results are bit-identical);
// finally uniques are stably sorted by decreasing abundance.
//
// Exposed as a tiny C ABI consumed through ctypes (no pybind11 in this
// build environment).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

struct Unique {
  std::string seq;
  int64_t count = 0;
  std::vector<double> qualsum;  // phred sums per position (seq.size())
};

struct DerepResult {
  std::vector<Unique> uniqs;      // final order (abundance-sorted)
  std::vector<int64_t> map;       // read -> unique (-1 for zero-length)
  int64_t nreads = 0;
  int maxlen = 0;
  std::string error;
};

struct Read {
  std::string seq;
  std::string qual;
};

// Bulk-buffered gz line scanner: one gzread per ~4MB, lines located with
// memchr (the per-line gzgets path costs ~2x on large files).
class GzLines {
 public:
  explicit GzLines(gzFile f) : f_(f) { buf_.resize(4 << 20); }

  // Returns false at EOF. The line (without newline) is [*p, *p + *len).
  bool next(const char **p, size_t *len) {
    for (;;) {
      const char *nl = (const char *)memchr(buf_.data() + pos_, '\n',
                                            end_ - pos_);
      if (nl != nullptr) {
        *p = buf_.data() + pos_;
        *len = (size_t)(nl - *p);
        if (*len > 0 && (*p)[*len - 1] == '\r') (*len)--;
        pos_ = (size_t)(nl - buf_.data()) + 1;
        return true;
      }
      // shift the partial line to the front and refill
      size_t rem = end_ - pos_;
      if (pos_ > 0) {
        memmove(buf_.data(), buf_.data() + pos_, rem);
        pos_ = 0;
        end_ = rem;
      }
      if (end_ == buf_.size()) buf_.resize(buf_.size() * 2);
      int got = gzread(f_, buf_.data() + end_,
                       (unsigned)(buf_.size() - end_));
      if (got <= 0) {
        if (rem == 0) return false;
        *p = buf_.data();
        *len = rem;
        if (*len > 0 && (*p)[*len - 1] == '\r') (*len)--;
        pos_ = end_;
        return true;
      }
      end_ += (size_t)got;
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
  size_t pos_ = 0, end_ = 0;
};

bool read_record(GzLines &in, Read &r, std::string &err) {
  const char *p;
  size_t len;
  if (!in.next(&p, &len)) return false;
  if (len == 0 || p[0] != '@') {
    err = "Malformed fastq record";
    return false;
  }
  if (!in.next(&p, &len)) { err = "Truncated fastq record"; return false; }
  r.seq.assign(p, len);
  if (!in.next(&p, &len)) { err = "Truncated fastq record"; return false; }
  if (!in.next(&p, &len)) { err = "Truncated fastq record"; return false; }
  r.qual.assign(p, len);
  return true;
}

}  // namespace

extern "C" {

DerepResult *derep_fastq_native(const char *path, int64_t chunk_size,
                                int phred_offset) {
  auto *res = new DerepResult();
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) {
    res->error = "Cannot open file";
    return res;
  }
  gzbuffer(f, 1 << 20);

  std::unordered_map<std::string, int64_t> seq2idx;
  std::vector<Read> chunk;
  chunk.reserve(chunk_size > 0 ? (size_t)chunk_size : 1024);
  bool eof = false;
  std::string err;

  auto process_chunk = [&](std::vector<Read> &reads) {
    size_t n = reads.size();
    if (n == 0) return;
    // lexical order, stable by read index (matches Python sorted())
    std::vector<int64_t> order;
    order.reserve(n);
    for (size_t i = 0; i < n; i++) {
      if (!reads[i].seq.empty()) order.push_back((int64_t)i);
    }
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       return reads[a].seq < reads[b].seq;
                     });
    // per-chunk uniques in lexical order with per-chunk qual sums
    struct ChunkU {
      const std::string *seq;
      int64_t count = 0;
      std::vector<double> qsum;
    };
    std::vector<ChunkU> cu;
    std::vector<int64_t> readmap(n, -1);
    const std::string *prev = nullptr;
    for (int64_t i : order) {
      const Read &r = reads[i];
      if (prev == nullptr || r.seq != *prev) {
        cu.push_back(ChunkU());
        cu.back().seq = &r.seq;
        cu.back().qsum.assign(r.seq.size(), 0.0);
        prev = &r.seq;
      }
      ChunkU &u = cu.back();
      u.count++;
      size_t L = std::min(r.qual.size(), r.seq.size());
      for (size_t p = 0; p < L; p++) {
        u.qsum[p] += (double)(r.qual[p] - phred_offset);
      }
      readmap[i] = (int64_t)cu.size() - 1;
    }
    // merge into global tables (encounter-order appends)
    std::vector<int64_t> new2old(cu.size());
    for (size_t k = 0; k < cu.size(); k++) {
      auto it = seq2idx.find(*cu[k].seq);
      int64_t j;
      if (it == seq2idx.end()) {
        j = (int64_t)res->uniqs.size();
        seq2idx.emplace(*cu[k].seq, j);
        res->uniqs.push_back(Unique());
        res->uniqs[j].seq = *cu[k].seq;
        res->uniqs[j].count = cu[k].count;
        res->uniqs[j].qualsum = std::move(cu[k].qsum);
      } else {
        j = it->second;
        res->uniqs[j].count += cu[k].count;
        std::vector<double> &gs = res->uniqs[j].qualsum;
        for (size_t p = 0; p < gs.size() && p < cu[k].qsum.size(); p++) {
          gs[p] += cu[k].qsum[p];
        }
      }
      new2old[k] = j;
    }
    for (size_t i = 0; i < n; i++) {
      res->map.push_back(readmap[i] >= 0 ? new2old[readmap[i]] : -1);
    }
    res->nreads += (int64_t)n;
    reads.clear();
  };

  GzLines lines(f);
  Read r;
  for (;;) {
    if (!read_record(lines, r, err)) {
      if (!err.empty()) {
        res->error = err;
        gzclose(f);
        return res;
      }
      break;
    }
    chunk.push_back(std::move(r));
    if ((int64_t)chunk.size() >= chunk_size) process_chunk(chunk);
  }
  process_chunk(chunk);
  gzclose(f);

  // stable sort by decreasing abundance; remap read map
  size_t nu = res->uniqs.size();
  std::vector<int64_t> ord(nu);
  for (size_t i = 0; i < nu; i++) ord[i] = (int64_t)i;
  std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
    return res->uniqs[a].count > res->uniqs[b].count;
  });
  std::vector<int64_t> inv(nu);
  std::vector<Unique> sorted;
  sorted.reserve(nu);
  for (size_t i = 0; i < nu; i++) {
    inv[ord[i]] = (int64_t)i;
    sorted.push_back(std::move(res->uniqs[ord[i]]));
  }
  res->uniqs = std::move(sorted);
  for (auto &m : res->map) {
    if (m >= 0) m = inv[m];
  }
  for (const auto &u : res->uniqs) {
    if ((int)u.seq.size() > res->maxlen) res->maxlen = (int)u.seq.size();
  }
  return res;
}

const char *dr_error(DerepResult *r) { return r->error.c_str(); }
int64_t dr_nuniq(DerepResult *r) { return (int64_t)r->uniqs.size(); }
int64_t dr_nreads(DerepResult *r) { return r->nreads; }
int dr_maxlen(DerepResult *r) { return r->maxlen; }

// seqs_out: nuniq*maxlen bytes (NUL padded); counts: nuniq; quals:
// nuniq*maxlen float64 (mean quality, NaN past each unique's length);
// map: nreads.
void dr_fill(DerepResult *r, char *seqs_out, int64_t *counts, double *quals,
             int64_t *map_out) {
  int64_t nu = (int64_t)r->uniqs.size();
  int ml = r->maxlen;
  for (int64_t i = 0; i < nu; i++) {
    const Unique &u = r->uniqs[i];
    memset(seqs_out + i * ml, 0, ml);
    memcpy(seqs_out + i * ml, u.seq.data(), u.seq.size());
    counts[i] = u.count;
    for (int p = 0; p < ml; p++) {
      if (p < (int)u.qualsum.size()) {
        quals[i * ml + p] = u.qualsum[p] / (double)u.count;
      } else {
        quals[i * ml + p] = NAN;
      }
    }
  }
  memcpy(map_out, r->map.data(), r->map.size() * sizeof(int64_t));
}

void dr_free(DerepResult *r) { delete r; }

}  // extern "C"
