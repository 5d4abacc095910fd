// Distance-2 greedy column colouring with no fixed cap, for the
// colored-probing device RAP (omp_amg_tpu_torch/ops/probe_rap.py).
//
// The same greedy as csrc/native.cc's d2_color_greedy: columns in ascending
// order, per-row colour bitmasks, the lowest colour that no earlier column
// sharing a row holds. native.cc's masks are 4 words wide, so it gives up
// above 256 colours. Here the mask width starts from the caller's estimate
// (a row of m entries needs m colours) and doubles whenever a column finds
// every colour of the current width taken. The colour picked then is the
// first of the new words, which is also the lowest free one, so the result
// does not depend on the width: wherever native.cc succeeds, this returns
// its colouring bit for bit.
//
// Built by omp_amg_tpu_torch/_build.py into the host library beside
// csrc/native.cc; bound with ctypes in omp_amg_tpu_torch/native.py.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// cindptr/cindices: the CSC (column -> rows) of the matrix whose columns are
// coloured; words: the starting mask width in 64-bit words (at least 1).
// Writes one colour per column and returns the number of colours.
int64_t d2_color_greedy_wide(int64_t n_rows, int64_t n_cols,
                             const int64_t* cindptr, const int32_t* cindices,
                             int64_t words, int32_t* color_out) {
  int64_t W = words < 1 ? 1 : words;
  std::vector<uint64_t> rowmask((size_t)n_rows * W, 0);
  std::vector<uint64_t> forb(W);
  int64_t ncolors = 0;
  for (int64_t j = 0; j < n_cols; ++j) {
    std::fill(forb.begin(), forb.end(), 0);
    for (int64_t p = cindptr[j]; p < cindptr[j + 1]; ++p) {
      const uint64_t* rm = rowmask.data() + (size_t)cindices[p] * W;
      for (int64_t w = 0; w < W; ++w) forb[w] |= rm[w];
    }
    int64_t c = -1;
    for (int64_t w = 0; w < W && c < 0; ++w) {
      const uint64_t free_bits = ~forb[w];
      if (free_bits) c = w * 64 + __builtin_ctzll(free_bits);
    }
    if (c < 0) {
      // every colour below 64*W is taken: widen the masks to 2W words
      const int64_t W2 = 2 * W;
      std::vector<uint64_t> wider((size_t)n_rows * W2, 0);
      for (int64_t r = 0; r < n_rows; ++r)
        for (int64_t w = 0; w < W; ++w)
          wider[(size_t)r * W2 + w] = rowmask[(size_t)r * W + w];
      rowmask.swap(wider);
      forb.assign(W2, 0);
      c = W * 64;
      W = W2;
    }
    color_out[j] = (int32_t)c;
    if (c + 1 > ncolors) ncolors = c + 1;
    const uint64_t bit = 1ull << (c & 63);
    const int64_t w = c >> 6;
    for (int64_t p = cindptr[j]; p < cindptr[j + 1]; ++p)
      rowmask[(size_t)cindices[p] * W + w] |= bit;
  }
  return ncolors;
}

}  // extern "C"
