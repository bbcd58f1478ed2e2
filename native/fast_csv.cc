// Native CSV point-cloud parser/writer for icp_tpu.
//
// Counterpart of the reference's C++ loader (reference
// src/load.cc:3-97): skip exactly one header row, take the first 3
// comma-separated floats per line (extra columns ignored, unparsable fields
// default to 0.0), write header "Points_0,Points_1,Points_2" + "%g" rows.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Single-pass mmap-free implementation; ~10x faster than the NumPy path on
// million-point clouds, which matters for the sharded-bench data pipeline.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Count data rows = lines - 1 (header), mirroring the reference's
// getline-count loop (src/load.cc:15-17).
long long count_rows(FILE* f) {
  long long lines = 0;
  int prev = '\n';
  char buf[1 << 16];
  size_t got;
  int last = '\n';
  while ((got = fread(buf, 1, sizeof buf, f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') ++lines;
    }
    last = buf[got - 1];
    prev = last;
  }
  (void)prev;
  if (last != '\n') ++lines;  // final line without trailing newline
  return lines - 1;
}

}  // namespace

extern "C" {

long long icp_csv_count_rows(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long long n = count_rows(f);
  std::fclose(f);
  return n;
}

// Parse into out[capacity*3] (row-major N x 3). Returns rows parsed, or -1.
long long icp_csv_load(const char* path, double* out, long long capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // Read whole file (clouds are at most a few hundred MB).
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data;
  data.resize((size_t)sz);
  if (sz > 0 && std::fread(&data[0], 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const char* p = data.c_str();
  const char* end = p + data.size();
  // Skip header line.
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  long long row = 0;
  while (p < end && row < capacity) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    double v[3] = {0.0, 0.0, 0.0};
    const char* q = p;
    for (int d = 0; d < 3 && q < line_end; ++d) {
      char* after = nullptr;
      double x = std::strtod(q, &after);
      // sscanf("%lf,...") semantics: no conversion stops the line; a number
      // whose whitespace skip crossed the line boundary does not count.
      if (after == q || after > line_end) break;
      v[d] = x;
      q = after;
      if (d < 2) {
        // The format's literal ',' must match the VERY next character —
        // trailing garbage before the separator ends the line (the parsed
        // prefix is kept), matching sscanf: "1.5abc,2,3" -> [1.5, 0, 0].
        if (q >= line_end || *q != ',') break;
        ++q;
      }
    }
    out[row * 3 + 0] = v[0];
    out[row * 3 + 1] = v[1];
    out[row * 3 + 2] = v[2];
    ++row;
    p = (line_end < end) ? line_end + 1 : end;
  }
  return row;
}

// Write header + %g rows (C++ ostream default = 6 significant digits),
// matching reference write_matrix (src/load.cc:68-97). Returns rows written.
long long icp_csv_write(const char* path, const double* data, long long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fputs("Points_0,Points_1,Points_2\n", f);
  char buf[128];
  for (long long i = 0; i < n; ++i) {
    int len = std::snprintf(buf, sizeof buf, "%g,%g,%g\n", data[i * 3],
                            data[i * 3 + 1], data[i * 3 + 2]);
    std::fwrite(buf, 1, (size_t)len, f);
  }
  std::fclose(f);
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched multi-file API (the SLAM chain loads N scans; IO + parse are
// embarrassingly parallel across files).  One std::thread per file up to
// hardware_concurrency; same per-file semantics as the single-file calls.
// ---------------------------------------------------------------------------

namespace {

template <typename Fn>
void parallel_over_files(long long n_files, Fn&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  long long n_workers = hw ? (long long)hw : 4;
  if (n_workers > n_files) n_workers = n_files;
  if (n_workers <= 1) {
    for (long long i = 0; i < n_files; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)n_workers);
  for (long long w = 0; w < n_workers; ++w) {
    pool.emplace_back([=]() {
      for (long long i = w; i < n_files; i += n_workers) fn(i);
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Row counts for n files in parallel; out_counts[i] = rows or -1.
void icp_csv_count_rows_batch(const char* const* paths, long long n,
                              long long* out_counts) {
  parallel_over_files(n, [&](long long i) {
    out_counts[i] = icp_csv_count_rows(paths[i]);
  });
}

// Parse n files in parallel into caller-allocated buffers outs[i]
// (capacities[i] rows each); results[i] = rows parsed or -1.
void icp_csv_load_batch(const char* const* paths, long long n,
                        double* const* outs, const long long* capacities,
                        long long* results) {
  parallel_over_files(n, [&](long long i) {
    results[i] = icp_csv_load(paths[i], outs[i], capacities[i]);
  });
}

}  // extern "C"
