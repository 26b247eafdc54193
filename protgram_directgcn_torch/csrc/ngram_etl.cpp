// Native n-gram ETL kernels for the graph builder (host code).
//
// A copy of the JAX package's native/ngram_etl.cpp: the C++ replacement for
// the reference's Dask-based ETL hot loops (reference:
// src/pipeline/data_builder.py:141-274 — n-gram hashing, consecutive-pair
// emission, groupby-count edge aggregation).  Built by g++ at first use
// (ops/_nvcc.py compile_host_source) and loaded with ctypes (native.py); the
// builder keeps its numpy path where the library does not build.
//
// Key packing matches graph/builder.py: big-endian byte packing of n<=8
// characters into uint64, so sorted keys == lexicographically sorted
// n-gram strings (the reference's sorted-id assignment,
// data_builder.py:164-172).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pack all n-gram windows of a byte sequence into uint64 keys.
// Returns the number of windows written (len - n + 1, or 0).
int64_t pack_ngrams(const uint8_t* seq, int64_t len, int32_t n, uint64_t* out) {
  if (len < n || n <= 0 || n > 8) return 0;
  uint64_t key = 0;
  const uint64_t mask = (n == 8) ? ~0ULL : ((1ULL << (8 * n)) - 1);
  for (int32_t i = 0; i < n; ++i) key = (key << 8) | seq[i];
  out[0] = key;
  const int64_t count = len - n + 1;
  for (int64_t i = 1; i < count; ++i) {
    key = ((key << 8) | seq[i + n - 1]) & mask;
    out[i] = key;
  }
  return count;
}

// Pack n-gram windows for a batch of concatenated sequences.
// offsets has n_seqs+1 entries delimiting each sequence in data.
// out must hold sum(max(0, len_i - n + 1)); out_counts[i] gets the window
// count of sequence i.  Returns total windows written.
int64_t pack_ngrams_batch(const uint8_t* data, const int64_t* offsets,
                          int64_t n_seqs, int32_t n, uint64_t* out,
                          int64_t* out_counts) {
  int64_t total = 0;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t len = offsets[s + 1] - offsets[s];
    const int64_t c = pack_ngrams(data + offsets[s], len, n, out + total);
    out_counts[s] = c;
    total += c;
  }
  return total;
}

// Emit consecutive-pair keys (src_id * nn + tgt_id) for ids grouped into
// sequences by window counts.  Returns number of pairs written.
int64_t emit_pairs(const int64_t* ids, const int64_t* counts, int64_t n_seqs,
                   uint64_t nn, uint64_t* out) {
  int64_t pos = 0, written = 0;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int64_t c = counts[s];
    for (int64_t i = 0; i + 1 < c; ++i) {
      out[written++] =
          static_cast<uint64_t>(ids[pos + i]) * nn + static_cast<uint64_t>(ids[pos + i + 1]);
    }
    pos += c;
  }
  return written;
}

// Sort-and-run-length aggregate uint64 keys.  keys is modified in place
// (sorted).  out_keys/out_counts must hold up to len entries.  Returns the
// number of unique keys.
int64_t aggregate_u64(uint64_t* keys, int64_t len, uint64_t* out_keys,
                      int64_t* out_counts) {
  if (len <= 0) return 0;
  std::sort(keys, keys + len);
  int64_t u = 0;
  uint64_t cur = keys[0];
  int64_t count = 1;
  for (int64_t i = 1; i < len; ++i) {
    if (keys[i] == cur) {
      ++count;
    } else {
      out_keys[u] = cur;
      out_counts[u] = count;
      ++u;
      cur = keys[i];
      count = 1;
    }
  }
  out_keys[u] = cur;
  out_counts[u] = count;
  return u + 1;
}

// Merge two sorted unique (key, count) runs, summing counts of equal keys.
// Returns merged length.  Out buffers must hold len_a + len_b entries.
int64_t merge_aggregates(const uint64_t* ka, const int64_t* ca, int64_t len_a,
                         const uint64_t* kb, const int64_t* cb, int64_t len_b,
                         uint64_t* out_keys, int64_t* out_counts) {
  int64_t i = 0, j = 0, u = 0;
  while (i < len_a && j < len_b) {
    if (ka[i] < kb[j]) {
      out_keys[u] = ka[i]; out_counts[u] = ca[i]; ++i;
    } else if (kb[j] < ka[i]) {
      out_keys[u] = kb[j]; out_counts[u] = cb[j]; ++j;
    } else {
      out_keys[u] = ka[i]; out_counts[u] = ca[i] + cb[j]; ++i; ++j;
    }
    ++u;
  }
  while (i < len_a) { out_keys[u] = ka[i]; out_counts[u] = ca[i]; ++i; ++u; }
  while (j < len_b) { out_keys[u] = kb[j]; out_counts[u] = cb[j]; ++j; ++u; }
  return u;
}

// Map sorted-vocab keys to ids via binary search (ids = rank; -1 if absent).
void lookup_sorted(const uint64_t* vocab, int64_t vocab_len,
                   const uint64_t* keys, int64_t n_keys, int64_t* out_ids) {
  for (int64_t i = 0; i < n_keys; ++i) {
    const uint64_t* lo = std::lower_bound(vocab, vocab + vocab_len, keys[i]);
    out_ids[i] = (lo != vocab + vocab_len && *lo == keys[i]) ? (lo - vocab) : -1;
  }
}

}  // extern "C"
