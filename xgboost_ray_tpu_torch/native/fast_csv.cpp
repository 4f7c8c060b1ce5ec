// Multithreaded CSV -> float32 parser of the port's CSV data source.
//
// A copy of the JAX package's xgboost_ray_tpu/native/fast_csv.cpp: the
// native analog of the host-side loading the reference delegates to
// pandas.read_csv inside its actors (xgboost_ray/data_sources/csv.py:26-43).
// Chunked std::from_chars parsing across hardware threads; each field is
// parsed straight to float32 (correctly rounded).
//
// Layout: two-pass. Pass 1 (single scan) counts rows/columns and records
// per-thread chunk boundaries at newline alignment. Pass 2 parses chunks in
// parallel straight into the caller's float32 buffer (row-major).
// Empty fields, "na"/"nan"/"null" (any case) and parse failures become NaN.
//
// C ABI (ctypes-friendly):
//   fcsv_open(path, skip_header)        -> handle (>0) or 0 on failure
//   fcsv_rows(h) / fcsv_cols(h)         -> dimensions
//   fcsv_header(h, buf, cap)            -> '\n'-joined header into buf
//   fcsv_parse(h, out, n_threads)       -> 0 on success (out: rows*cols f32)
//   fcsv_close(h)

#include <atomic>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct CsvFile {
  std::string data;
  std::string header;
  int64_t rows = 0;
  int64_t cols = 0;
  size_t body_offset = 0;  // first byte after the header row
};

std::mutex g_mutex;
std::map<int64_t, CsvFile*> g_files;
int64_t g_next_handle = 1;

bool is_na_token(const char* begin, const char* end) {
  size_t len = static_cast<size_t>(end - begin);
  if (len == 0) return true;
  if (len > 4) return false;
  char low[5] = {0, 0, 0, 0, 0};
  for (size_t i = 0; i < len; ++i)
    low[i] = static_cast<char>(std::tolower(static_cast<unsigned char>(begin[i])));
  return !std::strncmp(low, "na", 5) || !std::strncmp(low, "nan", 5) ||
         !std::strncmp(low, "null", 5);
}

// A line in data[begin, end) counts as a row iff this is false. Must be the
// single source of truth for both the row counters and the parser, or the
// parser writes a different number of rows than fcsv_rows() promised.
bool is_blank_line(const char* data, size_t begin, size_t end) {
  if (end <= begin) return true;                          // empty (LF only)
  return end - begin == 1 && data[begin] == '\r';         // bare CR from CRLF
}

float parse_field(const char* begin, const char* end) {
  while (begin < end && (*begin == ' ' || *begin == '\t')) ++begin;
  while (end > begin && (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) --end;
  if (begin >= end || is_na_token(begin, end))
    return std::numeric_limits<float>::quiet_NaN();
  float value;
  auto result = std::from_chars(begin, end, value);
  if (result.ec != std::errc()) return std::numeric_limits<float>::quiet_NaN();
  return value;
}

// Parse rows in data[begin, end) into out, starting at row_index `row0`.
void parse_span(const CsvFile& file, size_t begin, size_t end, int64_t row0,
                float* out) {
  const char* data = file.data.data();
  int64_t row = row0;
  size_t pos = begin;
  while (pos < end) {
    size_t line_end = pos;
    while (line_end < end && data[line_end] != '\n') ++line_end;
    if (!is_blank_line(data, pos, line_end)) {
      float* out_row = out + row * file.cols;
      size_t field_start = pos;
      int64_t col = 0;
      for (size_t i = pos; i <= line_end; ++i) {
        if (i == line_end || data[i] == ',') {
          if (col < file.cols)
            out_row[col] = parse_field(data + field_start, data + i);
          ++col;
          field_start = i + 1;
        }
      }
      for (; col < file.cols; ++col)
        out_row[col] = std::numeric_limits<float>::quiet_NaN();
      ++row;
    }
    pos = line_end + 1;
  }
}

}  // namespace

extern "C" {

int64_t fcsv_open(const char* path, int skip_header) {
  std::ifstream in(path, std::ios::binary | std::ios::ate);
  if (!in) return 0;
  auto size = in.tellg();
  in.seekg(0);
  auto* file = new CsvFile();
  file->data.resize(static_cast<size_t>(size));
  if (!in.read(file->data.data(), size)) {
    delete file;
    return 0;
  }

  const std::string& s = file->data;
  size_t pos = 0;
  if (skip_header && !s.empty()) {
    size_t eol = s.find('\n');
    if (eol == std::string::npos) eol = s.size();
    file->header = s.substr(0, eol);
    while (!file->header.empty() && file->header.back() == '\r')
      file->header.pop_back();
    pos = eol + 1 < s.size() ? eol + 1 : s.size();
  }
  file->body_offset = pos;

  // count columns from the first body line, rows from newline count
  size_t first_eol = s.find('\n', pos);
  if (first_eol == std::string::npos) first_eol = s.size();
  if (first_eol > pos) {
    file->cols = 1;
    for (size_t i = pos; i < first_eol; ++i)
      if (s[i] == ',') ++file->cols;
  }
  int64_t rows = 0;
  size_t scan = pos;
  while (scan < s.size()) {
    size_t eol = s.find('\n', scan);
    if (eol == std::string::npos) eol = s.size();
    if (!is_blank_line(s.data(), scan, eol)) ++rows;
    scan = eol + 1;
  }
  file->rows = rows;

  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t handle = g_next_handle++;
  g_files[handle] = file;
  return handle;
}

int64_t fcsv_rows(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_files.find(handle);
  return it == g_files.end() ? -1 : it->second->rows;
}

int64_t fcsv_cols(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_files.find(handle);
  return it == g_files.end() ? -1 : it->second->cols;
}

int64_t fcsv_header(int64_t handle, char* buf, int64_t cap) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_files.find(handle);
  if (it == g_files.end()) return -1;
  std::string header = it->second->header;
  for (char& c : header)
    if (c == ',') c = '\n';
  int64_t n = static_cast<int64_t>(header.size());
  if (n + 1 > cap) return -(n + 1);
  std::memcpy(buf, header.data(), static_cast<size_t>(n));
  buf[n] = '\0';
  return n;
}

int fcsv_parse(int64_t handle, float* out, int n_threads) {
  CsvFile* file;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_files.find(handle);
    if (it == g_files.end()) return 1;
    file = it->second;
  }
  if (file->rows == 0 || file->cols == 0) return 0;
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min<int>(n_threads, 64));

  const std::string& s = file->data;
  // chunk boundaries aligned to newlines, with the starting row of each chunk
  std::vector<size_t> starts{file->body_offset};
  size_t target = std::max<size_t>(1, (s.size() - file->body_offset) / n_threads);
  for (int t = 1; t < n_threads; ++t) {
    size_t probe = std::min(file->body_offset + t * target, s.size());
    size_t eol = s.find('\n', probe);
    starts.push_back(eol == std::string::npos ? s.size() : eol + 1);
  }
  starts.push_back(s.size());

  // rows before each chunk (serial newline count per chunk, then prefix sum)
  std::vector<int64_t> chunk_rows(n_threads, 0);
  {
    std::vector<std::thread> counters;
    for (int t = 0; t < n_threads; ++t) {
      counters.emplace_back([&, t] {
        int64_t rows = 0;
        size_t scan = starts[t];
        while (scan < starts[t + 1]) {
          size_t eol = s.find('\n', scan);
          if (eol == std::string::npos || eol >= starts[t + 1])
            eol = starts[t + 1];
          if (!is_blank_line(s.data(), scan, eol)) ++rows;
          scan = eol + 1;
        }
        chunk_rows[t] = rows;
      });
    }
    for (auto& th : counters) th.join();
  }
  std::vector<int64_t> row0(n_threads, 0);
  for (int t = 1; t < n_threads; ++t) row0[t] = row0[t - 1] + chunk_rows[t - 1];

  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back(
        [&, t] { parse_span(*file, starts[t], starts[t + 1], row0[t], out); });
  }
  for (auto& th : workers) th.join();
  return 0;
}

void fcsv_close(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_files.find(handle);
  if (it != g_files.end()) {
    delete it->second;
    g_files.erase(it);
  }
}

}  // extern "C"
