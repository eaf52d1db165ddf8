// Memory-mapped feature-index store (PalDB analog): the port's own copy of
// photon_ml_tpu/native/index_store.cc, with the same file format and the
// same extern "C" surface, so a store either package builds from the same
// items is the same file byte for byte, and each package opens the other's.
//
// The reference memory-maps off-heap PalDB stores on every executor because
// feature maps reach 10^7-10^8 string keys. Here the store is built once on
// the host and mmap'd read-only by every worker process; lookups never touch
// the Python heap.
//
// File layout (little-endian, 8-byte aligned):
//   [0]  magic   "PIDX1\0\0\0"                  (8 bytes)
//   [8]  u64     num_slots (power of two)
//   [16] u64     num_entries
//   [24] u64     key_blob_size
//   [32] slots:  num_slots * Slot {u64 hash, u64 key_off, u32 key_len,
//                u32 pad, i64 value}
//   [..] key byte blob
//
// Open addressing with linear probing at ~50% max load; FNV-1a 64 hashing.
// Empty slot: key_off == UINT64_MAX (hash, length and value zero).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'P', 'I', 'D', 'X', '1', 0, 0, 0};
constexpr uint64_t kEmpty = ~0ULL;

struct Header {
  char magic[8];
  uint64_t num_slots;
  uint64_t num_entries;
  uint64_t key_blob_size;
};

struct Slot {
  uint64_t hash;
  uint64_t key_off;
  uint32_t key_len;
  uint32_t pad;
  int64_t value;
};

struct Store {
  void* base;
  size_t size;
  const Header* header;
  const Slot* slots;
  const char* blob;
};

inline uint64_t fnv1a(const char* data, uint64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

inline uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Build a store from n keys (concatenated bytes + n+1 offsets) and values.
// Returns 0 on success, negative errno-style codes on failure.
int pidx_build(const char* path, const char* key_bytes, const uint64_t* offsets,
               uint64_t n, const int64_t* values) {
  uint64_t num_slots = next_pow2(n == 0 ? 2 : n * 2);  // ≤50% load
  uint64_t blob_size = offsets[n];

  Slot* slots = static_cast<Slot*>(calloc(num_slots, sizeof(Slot)));
  if (!slots) return -12;
  for (uint64_t i = 0; i < num_slots; ++i) slots[i].key_off = kEmpty;

  uint64_t mask = num_slots - 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t off = offsets[i];
    uint64_t len = offsets[i + 1] - off;
    uint64_t h = fnv1a(key_bytes + off, len);
    uint64_t s = h & mask;
    for (;;) {
      if (slots[s].key_off == kEmpty) {
        slots[s].hash = h;
        slots[s].key_off = off;
        slots[s].key_len = static_cast<uint32_t>(len);
        slots[s].value = values[i];
        break;
      }
      if (slots[s].hash == h && slots[s].key_len == len &&
          memcmp(key_bytes + slots[s].key_off, key_bytes + off, len) == 0) {
        free(slots);
        return -17;  // duplicate key
      }
      s = (s + 1) & mask;
    }
  }

  FILE* f = fopen(path, "wb");
  if (!f) {
    free(slots);
    return -2;
  }
  Header header;
  memcpy(header.magic, kMagic, 8);
  header.num_slots = num_slots;
  header.num_entries = n;
  header.key_blob_size = blob_size;
  int ok = fwrite(&header, sizeof(header), 1, f) == 1 &&
           fwrite(slots, sizeof(Slot), num_slots, f) == num_slots &&
           (blob_size == 0 || fwrite(key_bytes, 1, blob_size, f) == blob_size);
  free(slots);
  if (fclose(f) != 0 || !ok) return -5;
  return 0;
}

// Open (mmap) a store. Returns an opaque handle or nullptr.
void* pidx_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);  // mapping persists
  if (base == MAP_FAILED) return nullptr;

  const Header* header = static_cast<const Header*>(base);
  if (memcmp(header->magic, kMagic, 8) != 0) {
    munmap(base, st.st_size);
    return nullptr;
  }
  Store* store = new Store;
  store->base = base;
  store->size = st.st_size;
  store->header = header;
  store->slots = reinterpret_cast<const Slot*>(static_cast<const char*>(base) +
                                               sizeof(Header));
  store->blob = reinterpret_cast<const char*>(store->slots + header->num_slots);
  return store;
}

void pidx_close(void* handle) {
  Store* store = static_cast<Store*>(handle);
  if (!store) return;
  munmap(store->base, store->size);
  delete store;
}

uint64_t pidx_size(void* handle) {
  return static_cast<Store*>(handle)->header->num_entries;
}

int64_t pidx_get(void* handle, const char* key, uint32_t len) {
  const Store* store = static_cast<const Store*>(handle);
  uint64_t mask = store->header->num_slots - 1;
  uint64_t h = fnv1a(key, len);
  uint64_t s = h & mask;
  for (;;) {
    const Slot& slot = store->slots[s];
    if (slot.key_off == kEmpty) return -1;
    if (slot.hash == h && slot.key_len == len &&
        memcmp(store->blob + slot.key_off, key, len) == 0) {
      return slot.value;
    }
    s = (s + 1) & mask;
  }
}

// Bulk lookup: n keys as concatenated bytes + offsets; missing keys → -1.
void pidx_get_many(void* handle, const char* key_bytes, const uint64_t* offsets,
                   uint64_t n, int64_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t off = offsets[i];
    out[i] = pidx_get(handle, key_bytes + off,
                      static_cast<uint32_t>(offsets[i + 1] - off));
  }
}

// Iterate entries: copies entry i's key into key_buf (cap bytes, returns key
// length) and value into *value. For model IO / debugging, not hot paths.
int64_t pidx_entry(void* handle, uint64_t slot_index, char* key_buf,
                   uint64_t cap, int64_t* value) {
  const Store* store = static_cast<const Store*>(handle);
  if (slot_index >= store->header->num_slots) return -2;
  const Slot& slot = store->slots[slot_index];
  if (slot.key_off == kEmpty) return -1;
  uint64_t len = slot.key_len < cap ? slot.key_len : cap;
  memcpy(key_buf, store->blob + slot.key_off, len);
  *value = slot.value;
  return static_cast<int64_t>(slot.key_len);
}

uint64_t pidx_num_slots(void* handle) {
  return static_cast<Store*>(handle)->header->num_slots;
}

}  // extern "C"
