// Async frame ring buffer for the live viewer.
//
// The reference plotter decouples itself from the filter nodes by message
// queues and keeps only the latest state (copy-and-null of the incoming
// globals, plotting_node.py:233-252). The equivalent here: a device
// readback thread pushes flattened frame snapshots into this fixed-capacity
// native ring while the matplotlib render loop pops the NEWEST frame at its
// own rate — rendering never blocks device work and device work never waits
// on a slow draw. Overwrite-oldest semantics; drop count is surfaced so the
// consumer can report skipped frames. Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace {

struct Ring {
  std::mutex mu;
  std::vector<float> data;
  int slot_floats = 0;
  int n_slots = 0;
  int head = 0;   // next slot to write
  int count = 0;  // valid slots
  uint64_t pushed = 0;
  uint64_t dropped = 0;
};

std::mutex g_mu;
std::map<int64_t, Ring*> g_rings;
int64_t g_next_handle = 1;

Ring* get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_rings.find(h);
  return it == g_rings.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t ringbuf_create(int slot_floats, int n_slots) {
  if (slot_floats <= 0 || n_slots <= 0) return 0;
  Ring* r = new Ring();
  r->slot_floats = slot_floats;
  r->n_slots = n_slots;
  r->data.resize(static_cast<size_t>(slot_floats) * n_slots);
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_rings[h] = r;
  return h;
}

// Push one frame (n must equal slot_floats). Overwrites the oldest frame
// when full. Returns 1 on success, 0 on bad handle/size.
int ringbuf_push(int64_t h, const float* src, int n) {
  Ring* r = get(h);
  if (!r || n != r->slot_floats) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  std::memcpy(&r->data[static_cast<size_t>(r->head) * r->slot_floats], src,
              sizeof(float) * n);
  r->head = (r->head + 1) % r->n_slots;
  if (r->count < r->n_slots) {
    r->count++;
  } else {
    r->dropped++;  // overwrote the oldest unread frame
  }
  r->pushed++;
  return 1;
}

// Pop the NEWEST frame and discard everything older ("latest wins", the
// live-viewer semantic). Returns 1 if a frame was produced, 0 if empty.
int ringbuf_pop_latest(int64_t h, float* dst, int n) {
  Ring* r = get(h);
  if (!r || n != r->slot_floats) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  if (r->count == 0) return 0;
  int newest = (r->head - 1 + r->n_slots) % r->n_slots;
  std::memcpy(dst, &r->data[static_cast<size_t>(newest) * r->slot_floats],
              sizeof(float) * n);
  if (r->count > 1) r->dropped += r->count - 1;
  r->count = 0;
  return 1;
}

// FIFO pop of the oldest frame (for consumers that must see every frame,
// e.g. the CSV recorder). Returns 1 if a frame was produced.
int ringbuf_pop_oldest(int64_t h, float* dst, int n) {
  Ring* r = get(h);
  if (!r || n != r->slot_floats) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  if (r->count == 0) return 0;
  int oldest = (r->head - r->count + r->n_slots) % r->n_slots;
  std::memcpy(dst, &r->data[static_cast<size_t>(oldest) * r->slot_floats],
              sizeof(float) * n);
  r->count--;
  return 1;
}

int ringbuf_count(int64_t h) {
  Ring* r = get(h);
  if (!r) return -1;
  std::lock_guard<std::mutex> lk(r->mu);
  return r->count;
}

uint64_t ringbuf_dropped(int64_t h) {
  Ring* r = get(h);
  if (!r) return 0;
  std::lock_guard<std::mutex> lk(r->mu);
  return r->dropped;
}

void ringbuf_destroy(int64_t h) {
  Ring* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_rings.find(h);
    if (it == g_rings.end()) return;
    r = it->second;
    g_rings.erase(it);
  }
  delete r;
}

}  // extern "C"
