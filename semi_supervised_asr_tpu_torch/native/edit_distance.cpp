// Batched Levenshtein edit distance over int32 token sequences.
//
// Native counterpart of the reference's host-side scoring loop
// (SURVEY.md §3 #20): validation decodes thousands of utterances per eval
// and the O(U^2) DP per pair is pure scalar work — wrong for the TPU, right
// for C++.  Exposed to Python via ctypes (semi_supervised_asr_tpu_torch/
// utils/native_ops.py, which builds it with g++ at first use).
//
// Also computes the PER-style collapsed distance: an optional id-map table
// (train-vocab id -> class id, -1 = delete) is applied to both sequences
// before the DP, implementing TIMIT's 61->39 scoring fold without a Python
// round-trip.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// Map + filter a sequence through the optional fold table.
inline int map_seq(const int32_t* seq, int len, const int32_t* table,
                   int table_len, int32_t* out) {
  int n = 0;
  for (int i = 0; i < len; ++i) {
    int32_t v = seq[i];
    if (table != nullptr) {
      if (v < 0 || v >= table_len) continue;
      v = table[v];
      if (v < 0) continue;  // deleted class (e.g. TIMIT 'q', specials)
    }
    out[n++] = v;
  }
  return n;
}

inline int32_t levenshtein(const int32_t* a, int la, const int32_t* b,
                           int lb, std::vector<int32_t>& row) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  row.resize(lb + 1);
  for (int j = 0; j <= lb; ++j) row[j] = j;
  for (int i = 1; i <= la; ++i) {
    int32_t prev = row[0];  // D[i-1][j-1]
    row[0] = i;
    for (int j = 1; j <= lb; ++j) {
      int32_t cur = row[j];  // D[i-1][j]
      int32_t sub = prev + (a[i - 1] != b[j - 1] ? 1 : 0);
      int32_t del = cur + 1;
      int32_t ins = row[j - 1] + 1;
      row[j] = std::min(sub, std::min(del, ins));
      prev = cur;
    }
  }
  return row[lb];
}

}  // namespace

extern "C" {

// hyp:  [batch, hyp_stride] int32, lengths hyp_lens[batch]
// ref:  [batch, ref_stride] int32, lengths ref_lens[batch]
// table: fold table of size table_len, or nullptr
// out_dist[batch]: edit distance; out_reflen[batch]: folded ref length
void batch_edit_distance(const int32_t* hyp, const int32_t* hyp_lens,
                         int hyp_stride, const int32_t* ref,
                         const int32_t* ref_lens, int ref_stride, int batch,
                         const int32_t* table, int table_len,
                         int32_t* out_dist, int32_t* out_reflen) {
  std::vector<int32_t> row;
  std::vector<int32_t> ha(hyp_stride), rb(ref_stride);
  for (int b = 0; b < batch; ++b) {
    int la = map_seq(hyp + (int64_t)b * hyp_stride, hyp_lens[b], table,
                     table_len, ha.data());
    int lb = map_seq(ref + (int64_t)b * ref_stride, ref_lens[b], table,
                     table_len, rb.data());
    out_dist[b] = levenshtein(ha.data(), la, rb.data(), lb, row);
    out_reflen[b] = lb;
  }
}

}  // extern "C"
