// The streamed tier's per-hop page read, on the host: one call copies every
// requested page record out of the page file's mapping, in request order,
// through the staging cache's exact LRU. It is the compiled form of the loop
// in repro_torch/core/stream.py (PageFetcher's plain path), which it must
// equal record for record and in its hit and miss counts. Host code only: it
// is built with the host's C++ compiler and loaded with ctypes, which drops
// the interpreter lock for the call.
#include <cstdint>
#include <cstring>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

// An exact LRU over page ids: `cap` slots in a doubly linked list, the least
// recently used at `head`, the most recently used at `tail`, and a map from
// page id to slot. The stage keeps ids only: a hit and a miss both copy the
// record from the mapping, as the plain loop's stage holds views of it.
struct Stage {
  explicit Stage(int32_t cap) : cap(cap), pid(cap), prev(cap), next(cap) {
    where.reserve(2 * static_cast<size_t>(cap));
  }

  void unlink(int32_t s) {
    if (prev[s] >= 0) next[prev[s]] = next[s]; else head = next[s];
    if (next[s] >= 0) prev[next[s]] = prev[s]; else tail = prev[s];
  }

  void push_back(int32_t s) {
    prev[s] = tail;
    next[s] = -1;
    if (tail >= 0) next[tail] = s; else head = s;
    tail = s;
  }

  // Marks page `p` most recently used; true when it was staged (a hit). A
  // miss takes a free slot, or the least recently used page's once all
  // `cap` are taken: the plain loop inserts, then evicts above `cap`, which
  // leaves the same pages in the same order.
  bool touch(int64_t p) {
    auto it = where.find(p);
    if (it != where.end()) {
      const int32_t s = it->second;
      if (s != tail) {
        unlink(s);
        push_back(s);
      }
      return true;
    }
    // the map grows first: if that throws, the stage is as it was
    const int32_t s = used < cap ? used : head;
    where.emplace(p, s);
    if (used < cap) {
      ++used;
    } else {
      unlink(s);
      where.erase(pid[s]);
    }
    pid[s] = p;
    push_back(s);
    return false;
  }

  int32_t cap;
  std::vector<int64_t> pid;
  std::vector<int32_t> prev, next;
  int32_t head = -1, tail = -1, used = 0;
  std::unordered_map<int64_t, int32_t> where;
};

}  // namespace

extern "C" {

// A staging cache of `stage_pages` >= 1 pages, or null if it cannot be made.
void* pageann_stage_new(int64_t stage_pages) {
  if (stage_pages < 1 || stage_pages > INT32_MAX) return nullptr;
  try {
    return new Stage(static_cast<int32_t>(stage_pages));
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void pageann_stage_free(void* stage) { delete static_cast<Stage*>(stage); }

// For j in [0, n): out[j] = the record of page ids[j] (`rec_bytes` bytes at
// recs + ids[j] * rec_bytes), or zeros where ids[j] < 0, which the stage
// never sees. Every id is below the record count (the caller checks).
// counts[0] = staging misses, counts[1] = staging hits. Returns 0, or 1 if
// the stage's map could not grow (the records before the failing id are
// written, and the stage is what the plain loop's would be after them).
int pageann_page_fetch(void* stage, const int64_t* ids, int64_t n,
                       const char* recs, int64_t rec_bytes, char* out,
                       int64_t* counts) {
  Stage* st = static_cast<Stage*>(stage);
  int64_t misses = 0, hits = 0;
  int rc = 0;
  try {
    for (int64_t j = 0; j < n; ++j) {
      char* dst = out + j * rec_bytes;
      const int64_t p = ids[j];
      if (p < 0) {
        std::memset(dst, 0, static_cast<size_t>(rec_bytes));
        continue;
      }
      if (st->touch(p)) ++hits; else ++misses;
      std::memcpy(dst, recs + p * rec_bytes, static_cast<size_t>(rec_bytes));
    }
  } catch (const std::bad_alloc&) {
    rc = 1;
  }
  counts[0] = misses;
  counts[1] = hits;
  return rc;
}

}  // extern "C"
