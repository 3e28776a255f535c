// Host-side payload pool — the native counterpart of the reference's
// refcounted shared Payload (ref: payload.c:17-30: a mutex-guarded
// refcounted byte buffer so packet copies share one payload across
// threads). Device packets carry only a payloadRef int32 (SURVEY.md
// §7.2); the bytes live here. ref() on send, unref() on final
// delivery/drop; slots are recycled through a free list so the id
// space stays dense (int32-addressable from device words).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> data;
  int32_t refs = 0;
};

struct Pool {
  std::mutex mu;
  std::vector<Slot> slots;
  std::vector<int32_t> free_list;
  int64_t live_bytes = 0;
  int64_t total_allocs = 0;
};

}  // namespace

extern "C" {

void* payload_pool_new() { return new Pool(); }

void payload_pool_free(void* p) { delete static_cast<Pool*>(p); }

// store bytes, returns payload ref (>= 0) with refcount 1
int32_t payload_pool_put(void* p, const uint8_t* data, int64_t len) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  int32_t id;
  if (!pool->free_list.empty()) {
    id = pool->free_list.back();
    pool->free_list.pop_back();
  } else {
    id = static_cast<int32_t>(pool->slots.size());
    pool->slots.emplace_back();
  }
  Slot& s = pool->slots[id];
  s.data.assign(data, data + len);
  s.refs = 1;
  pool->live_bytes += len;
  pool->total_allocs++;
  return id;
}

int32_t payload_pool_ref(void* p, int32_t id) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (id < 0 || id >= (int32_t)pool->slots.size()) return -1;
  return ++pool->slots[id].refs;
}

int32_t payload_pool_unref(void* p, int32_t id) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (id < 0 || id >= (int32_t)pool->slots.size()) return -1;
  Slot& s = pool->slots[id];
  if (s.refs <= 0) return -1;
  if (--s.refs == 0) {
    pool->live_bytes -= static_cast<int64_t>(s.data.size());
    s.data.clear();
    s.data.shrink_to_fit();
    pool->free_list.push_back(id);
  }
  return s.refs;
}

int64_t payload_pool_len(void* p, int32_t id) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (id < 0 || id >= (int32_t)pool->slots.size()) return -1;
  return static_cast<int64_t>(pool->slots[id].data.size());
}

// copy out up to cap bytes; returns copied count
int64_t payload_pool_get(void* p, int32_t id, uint8_t* out, int64_t cap) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (id < 0 || id >= (int32_t)pool->slots.size()) return -1;
  const Slot& s = pool->slots[id];
  int64_t n = std::min<int64_t>(cap, s.data.size());
  std::memcpy(out, s.data.data(), n);
  return n;
}

int64_t payload_pool_live_bytes(void* p) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  return pool->live_bytes;
}

int64_t payload_pool_total_allocs(void* p) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  return pool->total_allocs;
}

int64_t payload_pool_live_count(void* p) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  int64_t n = 0;
  for (const Slot& s : pool->slots) n += (s.refs > 0);
  return n;
}

int64_t payload_pool_live_ids(void* p, int32_t* out, int64_t cap) {
  Pool* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  int64_t n = 0;
  for (size_t i = 0; i < pool->slots.size() && n < cap; ++i) {
    if (pool->slots[i].refs > 0) out[n++] = static_cast<int32_t>(i);
  }
  return n;
}

}  // extern "C"
