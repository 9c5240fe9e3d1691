// Host-side collation: right-pad variable-length per-sample arrays into
// one fixed-shape batch in a single call, in place of a Python loop per
// sample and field.  The port's copy of the JAX package's
// fastcollate.cc, loaded with ctypes by mca_tpu_torch/native/__init__.py,
// which checks every row's length and width before it passes pointers.
//
// Conventions of the reference collators: the pad value fills the tail;
// a mask entry is 1 / true where the position is padding.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// One pad_seq2d_f32 call's arguments, shared read-only by its threads.
struct Seq2d {
  const float** rows;
  const int64_t* t_lens;
  int64_t pad_len, width;
  float fill;
  bool clean;
  float* out;
  bool* mask_out;
};

// numpy's nan_to_num of one value without a branch, so that the loop
// over a row vectorises: NaN -> 0, +-Inf -> +-FLT_MAX; -0.0 and
// denormals pass unchanged.
inline float cleaned(float v) {
  const float kMax = 3.4028234663852886e38f;
  v = v == v ? v : 0.0f;
  v = v > kMax ? kMax : v;
  return v < -kMax ? -kMax : v;
}

// Rows [begin, end): each live value read once and written once
// (cleaned or copied), then the tail's fill and the row's mask.
void pad_seq2d_rows(const Seq2d& a, int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    float* dst = a.out + i * a.pad_len * a.width;
    const float* src = a.rows[i];
    const int64_t t = src == nullptr ? 0 : std::min(a.t_lens[i], a.pad_len);
    const int64_t live = t * a.width;
    if (a.clean) {
      for (int64_t j = 0; j < live; ++j) dst[j] = cleaned(src[j]);
    } else if (live > 0) {
      std::memcpy(dst, src, live * sizeof(float));
    }
    std::fill(dst + live, dst + a.pad_len * a.width, a.fill);
    bool* m = a.mask_out + i * a.pad_len;
    std::fill(m, m + t, false);
    std::fill(m + t, m + a.pad_len, true);
  }
}

}  // namespace

extern "C" {

// 1-D rows -> [n_rows, pad_len] f32, each cut to pad_len, and the mask
// out == pad_value, taken after padding, so a live value equal to the
// pad token is masked too.  mask_out may be null.
void pad_rows_f32(const float** rows, const int64_t* lens, int64_t n_rows,
                  int64_t pad_len, float pad_value, float* out,
                  int64_t* mask_out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    float* dst = out + i * pad_len;
    const int64_t n = lens[i] < pad_len ? lens[i] : pad_len;
    if (rows[i] != nullptr && n > 0) {
      std::memcpy(dst, rows[i], n * sizeof(float));
    }
    for (int64_t j = n; j < pad_len; ++j) dst[j] = pad_value;
    if (mask_out != nullptr) {
      int64_t* m = mask_out + i * pad_len;
      for (int64_t j = 0; j < pad_len; ++j) m[j] = dst[j] == pad_value;
    }
  }
}

// 1-D rows -> [n_rows, pad_len] f32 with a constant fill and no mask
// (the secondary column of a sequence modality).
void pad_rows_fill_f32(const float** rows, const int64_t* lens,
                       int64_t n_rows, int64_t pad_len, float fill,
                       float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    float* dst = out + i * pad_len;
    const int64_t n = lens[i] < pad_len ? lens[i] : pad_len;
    if (rows[i] != nullptr && n > 0) {
      std::memcpy(dst, rows[i], n * sizeof(float));
    }
    for (int64_t j = n; j < pad_len; ++j) dst[j] = fill;
  }
}

// [T_i, width] rows (T_i <= pad_len, every row exactly width wide) ->
// [n_rows, pad_len, width] f32 and the length mask (t >= T_i).  With
// clean, numpy's nan_to_num on the copied values: NaN -> 0,
// +-Inf -> +-FLT_MAX.  Rows are independent: n_threads threads (at most
// one a row; the calling thread is one of them) take contiguous blocks
// of rows.
void pad_seq2d_f32(const float** rows, const int64_t* t_lens, int64_t n_rows,
                   int64_t pad_len, int64_t width, float fill, int clean,
                   float* out, bool* mask_out, int64_t n_threads) {
  const Seq2d job{rows, t_lens, pad_len, width, fill, clean != 0, out, mask_out};
  const int64_t workers = std::max<int64_t>(1, std::min(n_threads, n_rows));
  std::vector<std::thread> pool;
  pool.reserve(workers - 1);
  for (int64_t w = 1; w < workers; ++w) {
    const int64_t begin = n_rows * w / workers, end = n_rows * (w + 1) / workers;
    try {
      pool.emplace_back(pad_seq2d_rows, job, begin, end);
    } catch (const std::system_error&) {  // no thread to be had: do the block here
      pad_seq2d_rows(job, begin, end);
    }
  }
  pad_seq2d_rows(job, 0, n_rows / workers);
  for (std::thread& t : pool) t.join();
}

}  // extern "C"
