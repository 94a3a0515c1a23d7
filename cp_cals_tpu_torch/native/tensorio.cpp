// Fast reader/writer for the reference's text tensor format: first line is
// the mode sizes separated by spaces, then one value per line, column-major
// order (first mode varying fastest). A copy of the JAX package's
// cp_cals_tpu/native/tensorio.cpp.
//
// A C++ parser because the Python float loop is ~50x slower on the
// 100^3-500^3 tensors the experiments use. Exposed via ctypes; built with
// g++ at first use by cp_cals_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parses the header only: fills modes[0..max_modes) and returns the number
// of modes, or -1 on error.
int tensor_file_modes(const char *path, int64_t *modes, int max_modes) {
  FILE *f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  if (!std::fgets(line, sizeof line, f)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  int n = 0;
  char *p = line;
  while (*p && n < max_modes) {
    char *end;
    long long v = std::strtoll(p, &end, 10);
    if (end == p) break;
    modes[n++] = v;
    p = end;
  }
  return n;
}

// Reads n_elements values (one per line after the header) into out.
// Returns the number of values read, or -1 on error.
int64_t tensor_file_read(const char *path, double *out, int64_t n_elements) {
  FILE *f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  if (!std::fgets(line, sizeof line, f)) {  // skip header
    std::fclose(f);
    return -1;
  }
  int64_t count = 0;
  // Buffered bulk parse: strtod over chunks.
  std::vector<char> buf(1 << 20);
  size_t have = 0;
  while (count < n_elements) {
    size_t got = std::fread(buf.data() + have, 1, buf.size() - have - 1, f);
    if (got == 0 && have == 0) break;
    have += got;
    buf[have] = '\0';
    char *p = buf.data();
    char *last = buf.data();
    while (count < n_elements) {
      char *end;
      double v = std::strtod(p, &end);
      if (end == p) break;
      // Incomplete trailing token unless we hit EOF.
      if (end == buf.data() + have && got != 0) break;
      out[count++] = v;
      p = end;
      last = end;
    }
    have -= static_cast<size_t>(last - buf.data());
    std::memmove(buf.data(), last, have);
    if (got == 0) break;
  }
  std::fclose(f);
  return count;
}

// Writes a tensor in the same format.
int tensor_file_write(const char *path, const int64_t *modes, int n_modes,
                      const double *data, int64_t n_elements) {
  FILE *f = std::fopen(path, "w");
  if (!f) return -1;
  for (int i = 0; i < n_modes; ++i)
    std::fprintf(f, "%lld%c", static_cast<long long>(modes[i]),
                 i + 1 == n_modes ? '\n' : ' ');
  for (int64_t i = 0; i < n_elements; ++i)
    std::fprintf(f, "%.17g\n", data[i]);
  std::fclose(f);
  return 0;
}

}  // extern "C"
