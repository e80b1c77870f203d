// Native IO data plane of mxnet_tpu_torch, a copy of mxnet_tpu's (parity: the
// reference's C++ IO layer —
// dmlc recordio framing `src/io/`, `iter_csv.cc`, and the read-ahead of
// `iter_prefetcher.h` / dmlc ThreadedIter).
//
// Design: plain C ABI over small C++ classes, loaded from Python via ctypes
// (the environment has no pybind11; see repo docs). Buffers returned to
// Python stay owned by the handle until the next call on that handle, so the
// ctypes side copies them into Python bytes without any custom allocator
// protocol.
//
// RecordIO framing (compatible with mxnet_tpu_torch/recordio.py and files
// written with cflag=0 by the reference tools):
//   [u32 magic = 0xced7230a][u32 lrec][data][pad to 4-byte boundary]
//   lrec: upper 3 bits continuation flag (only 0 = complete emitted here),
//         lower 29 bits payload length.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

static const uint32_t kMagic = 0xced7230a;

extern "C" {

// ---------------------------------------------------------------------------
// RecordIO writer
// ---------------------------------------------------------------------------

struct RecWriter {
  FILE* f;
  uint64_t offset;
};

void* mxtpu_recio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  return new RecWriter{f, 0};
}

// Appends one record; returns the byte offset of the record start (for
// .idx files), or -1 on error. Payloads >= 2^29 are rejected (the framing
// has 29 length bits).
long long mxtpu_recio_write(void* h, const char* data, uint64_t len) {
  auto* w = static_cast<RecWriter*>(h);
  if (len >= (1u << 29)) return -1;
  uint64_t start = w->offset;
  uint32_t lrec = static_cast<uint32_t>(len);
  if (fwrite(&kMagic, 4, 1, w->f) != 1) return -1;
  if (fwrite(&lrec, 4, 1, w->f) != 1) return -1;
  if (len && fwrite(data, 1, len, w->f) != len) return -1;
  uint32_t pad = (4 - (len & 3)) & 3;
  uint32_t zero = 0;
  if (pad && fwrite(&zero, 1, pad, w->f) != pad) return -1;
  w->offset += 8 + len + pad;
  return static_cast<long long>(start);
}

void mxtpu_recio_writer_close(void* h) {
  auto* w = static_cast<RecWriter*>(h);
  if (w) {
    fclose(w->f);
    delete w;
  }
}

// ---------------------------------------------------------------------------
// RecordIO reader
// ---------------------------------------------------------------------------

struct RecReader {
  FILE* f;
  std::vector<char> buf;
};

void* mxtpu_recio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new RecReader{f, {}};
}

// Reads the next record; returns length and sets *out to an internal buffer
// (valid until the next read on this handle). Returns -1 at EOF, -2 on a
// framing error.
long long mxtpu_recio_read(void* h, char** out) {
  auto* r = static_cast<RecReader*>(h);
  uint32_t magic = 0, lrec = 0;
  if (fread(&magic, 4, 1, r->f) != 1) return -1;
  if (magic != kMagic) return -2;
  if (fread(&lrec, 4, 1, r->f) != 1) return -2;
  uint32_t cflag = lrec >> 29;
  uint64_t len = lrec & ((1u << 29) - 1);
  if (cflag != 0) return -2;  // multipart records not emitted by our writers
  r->buf.resize(len);
  if (len && fread(r->buf.data(), 1, len, r->f) != len) return -2;
  uint32_t pad = (4 - (len & 3)) & 3;
  if (pad) fseek(r->f, pad, SEEK_CUR);
  *out = r->buf.data();
  return static_cast<long long>(len);
}

void mxtpu_recio_seek(void* h, uint64_t pos) {
  fseek(static_cast<RecReader*>(h)->f, static_cast<long>(pos), SEEK_SET);
}

uint64_t mxtpu_recio_tell(void* h) {
  return static_cast<uint64_t>(ftell(static_cast<RecReader*>(h)->f));
}

void mxtpu_recio_reader_close(void* h) {
  auto* r = static_cast<RecReader*>(h);
  if (r) {
    fclose(r->f);
    delete r;
  }
}

// ---------------------------------------------------------------------------
// CSV parser (float32 matrix; parity: src/io/iter_csv.cc)
// ---------------------------------------------------------------------------

// First pass: count rows/cols. Returns 0 on success.
int mxtpu_csv_shape(const char* path, long long* rows, long long* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long long r = 0, c = 0, cur_c = 0;
  bool in_field = false, any = false;
  int ch;
  while ((ch = fgetc(f)) != EOF) {
    if (ch == ',') {
      ++cur_c;
      in_field = false;
    } else if (ch == '\n') {
      if (any || cur_c > 0) {
        ++r;
        long long row_c = cur_c + 1;
        if (c == 0) c = row_c;
        else if (c != row_c) { fclose(f); return -2; }
      }
      cur_c = 0;
      in_field = false;
      any = false;
    } else if (ch != '\r' && ch != ' ' && ch != '\t') {
      in_field = true;
      any = true;
    }
  }
  if (any || cur_c > 0) {   // last line without trailing newline
    ++r;
    long long row_c = cur_c + 1;
    if (c == 0) c = row_c;
    else if (c != row_c) { fclose(f); return -2; }
  }
  fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

// Second pass: fill a preallocated rows*cols float32 buffer. Returns number
// of values parsed or negative on error.
long long mxtpu_csv_read(const char* path, float* out, long long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // read whole file (CSV files here are modest; simple & fast)
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> text(static_cast<size_t>(size) + 1);
  if (size && fread(text.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  text[size] = '\0';
  long long n = 0;
  char* p = text.data();
  char* end = p + size;
  while (p < end) {
    while (p < end && (*p == ',' || *p == '\n' || *p == '\r' || *p == ' '
                       || *p == '\t'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) return -2;
    if (n >= capacity) return -3;
    out[n++] = v;
    p = next;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Threaded RecordIO prefetcher (parity: iter_prefetcher.h read-ahead)
// ---------------------------------------------------------------------------

struct Prefetcher {
  FILE* f = nullptr;
  size_t capacity;
  std::deque<std::vector<char>> queue;
  std::vector<char> current;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::atomic<bool> done{false}, stop{false}, error{false};
  std::thread worker;

  void run() {
    while (!stop.load()) {
      uint32_t magic = 0, lrec = 0;
      if (fread(&magic, 4, 1, f) != 1) break;                  // EOF
      if (magic != kMagic) { error = true; break; }
      if (fread(&lrec, 4, 1, f) != 1) { error = true; break; }
      if ((lrec >> 29) != 0) { error = true; break; }
      uint64_t len = lrec & ((1u << 29) - 1);
      std::vector<char> rec(len);
      if (len && fread(rec.data(), 1, len, f) != len) { error = true; break; }
      uint32_t pad = (4 - (len & 3)) & 3;
      if (pad) fseek(f, pad, SEEK_CUR);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < capacity || stop.load(); });
      if (stop.load()) break;
      queue.emplace_back(std::move(rec));
      cv_pop.notify_one();
    }
    done = true;
    std::lock_guard<std::mutex> lk(mu);
    cv_pop.notify_all();
  }
};

void* mxtpu_prefetch_open(const char* path, int capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* p = new Prefetcher();
  p->f = f;
  p->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 16;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks for the next prefetched record; -1 at end, -2 on framing error.
long long mxtpu_prefetch_next(void* h, char** out) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_pop.wait(lk, [&] { return !p->queue.empty() || p->done.load(); });
  if (p->queue.empty())
    return p->error.load() ? -2 : -1;
  p->current = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_push.notify_one();
  *out = p->current.data();
  return static_cast<long long>(p->current.size());
}

void mxtpu_prefetch_close(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p) return;
  p->stop = true;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cv_push.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  fclose(p->f);
  delete p;
}

}  // extern "C"
