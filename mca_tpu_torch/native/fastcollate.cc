// Host-side collation: right-pad variable-length per-sample arrays into
// one fixed-shape batch in a single call, in place of a Python loop per
// sample and field.  The port's copy of the JAX package's
// fastcollate.cc, loaded with ctypes by mca_tpu_torch/native/__init__.py,
// which checks every row's length and width before it passes pointers.
//
// Conventions of the reference collators: the pad value fills the tail;
// a mask entry is 1 / true where the position is padding.

#include <cstdint>
#include <cstring>

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
// +-Inf -> +-FLT_MAX.
void pad_seq2d_f32(const float** rows, const int64_t* t_lens, int64_t n_rows,
                   int64_t pad_len, int64_t width, float fill, int clean,
                   float* out, bool* mask_out) {
  const float kMax = 3.4028234663852886e38f;
  for (int64_t i = 0; i < n_rows; ++i) {
    float* dst = out + i * pad_len * width;
    const int64_t t = t_lens[i] < pad_len ? t_lens[i] : pad_len;
    if (rows[i] != nullptr && t > 0) {
      std::memcpy(dst, rows[i], t * width * sizeof(float));
      if (clean) {
        for (int64_t j = 0; j < t * width; ++j) {
          const float v = dst[j];
          if (!(v == v)) dst[j] = 0.0f;
          else if (v > kMax) dst[j] = kMax;
          else if (v < -kMax) dst[j] = -kMax;
        }
      }
    }
    float* tail = dst + t * width;
    for (int64_t j = 0; j < (pad_len - t) * width; ++j) tail[j] = fill;
    bool* m = mask_out + i * pad_len;
    for (int64_t j = 0; j < pad_len; ++j) m[j] = j >= t;
  }
}

}  // extern "C"
