// Native columnar Avro ingest for TrainingExample-shaped records (the
// port's own copy of photon_ml_tpu/native/avro_ingest.cc: the same opcode
// program, the same extern "C" surface, the same deflate handling).
//
// The pure-Python codec (io/avro.py) spends a fraction of a millisecond on
// each record; this decoder runs a small schema "program" that
// io/native_ingest.py compiles from the file's writer schema, and produces
// COLUMNAR output directly:
//   - numeric fields      -> double columns
//   - feature bags        -> CSR (row_ptr, interned-key id, float value)
//                            plus a first-seen-order unique-key table, so
//                            Python materializes each distinct feature
//                            string ONCE, never per occurrence
//   - metadataMap id tags -> per-row interned entity ids + unique table
//   - uid                 -> raw bytes + per-row kind (missing/string/long)
//
// Opcode layout (4 x u32 per op): [code, a, b, c]
//   0 END
//   1 SKIP        a=kind (0 long/int/enum, 1 double, 2 float, 3 string/bytes,
//                         4 bool, 5 null, 6 map<string>, 7 array<NTV>)
//   2 CAPNUM      a=slot, b=kind (0 long, 1 double, 2 float),
//                 c=flags: bit0 nullable-union, bit1 null-is-second-branch
//   3 BAG         a=bag_id, b=perm (index into the 6 permutations of
//                 (name, term, value) field order), c=flags: bit0
//                 value-is-float, bit1 nullable-union, bit2 null-second,
//                 bit3 pair keys (see below)
//   4 TAGMAP      c=flags (union bits as above); map<string> whose keys are
//                 matched against the configured tag names
//   5 UID         c=flags: bit0 nullable, bit2 has-long-branch
//                 (union [null, string, long] in that order, or [null,
//                 string], or plain string)
//   6 SKIPOPT     a=kind, c=flags — nullable skip
//
// Feature key interning uses the same key convention as the Python side:
// name + 0x01 + term when term is non-empty, else name alone. With the
// pair-keys flag a key is the name's byte length in decimal, ':', the name
// and the term, so each distinct (name, term) pair is one key even where a
// name holds 0x01 (the name-and-term bags tool reads these).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr char kDelimiter = '\x01';

// ---------------------------------------------------------------- reader
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  int64_t read_long() {  // zigzag varint
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) {
        ok = false;
        return 0;
      }
    }
    return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
  }
  double read_double() {
    if (!need(8)) return 0.0;
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  float read_float() {
    if (!need(4)) return 0.0f;
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  // returns pointer to len bytes (within the buffer)
  const char* read_bytes(uint64_t* len) {
    int64_t n = read_long();
    if (n < 0 || !need(static_cast<size_t>(n))) {
      ok = false;
      *len = 0;
      return nullptr;
    }
    const char* out = reinterpret_cast<const char*>(p);
    p += n;
    *len = static_cast<uint64_t>(n);
    return out;
  }
  void skip_bytes_field() {
    uint64_t len;
    (void)read_bytes(&len);
  }
};

// ------------------------------------------------------------- interning
struct StrTable {
  std::vector<char> blob;
  std::vector<uint64_t> offs{0};
  std::vector<int64_t> slots;  // open addressing, -1 empty
  uint64_t mask = 0;

  StrTable() { rehash(1 << 10); }

  uint64_t size() const { return offs.size() - 1; }

  static uint64_t hash(const char* s, uint64_t n) {
    uint64_t h = 1469598103934665603ULL;  // FNV-1a
    for (uint64_t i = 0; i < n; i++) {
      h ^= static_cast<uint8_t>(s[i]);
      h *= 1099511628211ULL;
    }
    return h;
  }
  void rehash(uint64_t cap) {
    std::vector<int64_t> ns(cap, -1);
    uint64_t nm = cap - 1;
    for (uint64_t id = 0; id < size(); id++) {
      const char* s = blob.data() + offs[id];
      uint64_t n = offs[id + 1] - offs[id];
      uint64_t h = hash(s, n) & nm;
      while (ns[h] >= 0) h = (h + 1) & nm;
      ns[h] = static_cast<int64_t>(id);
    }
    slots.swap(ns);
    mask = nm;
  }
  uint32_t intern(const char* s, uint64_t n) {
    if (size() * 2 >= slots.size()) rehash(slots.size() * 2);
    uint64_t h = hash(s, n) & mask;
    while (slots[h] >= 0) {
      uint64_t id = static_cast<uint64_t>(slots[h]);
      uint64_t len = offs[id + 1] - offs[id];
      if (len == n && std::memcmp(blob.data() + offs[id], s, n) == 0)
        return static_cast<uint32_t>(id);
      h = (h + 1) & mask;
    }
    uint64_t id = size();
    blob.insert(blob.end(), s, s + n);
    offs.push_back(blob.size());
    slots[h] = static_cast<int64_t>(id);
    return static_cast<uint32_t>(id);
  }
};

// --------------------------------------------------------------- outputs
struct Bag {
  StrTable uniq;
  std::vector<int64_t> rowptr{0};
  std::vector<uint32_t> ids;
  std::vector<float> vals;
  std::vector<char> keybuf;  // scratch for name+delim+term
};

struct Tag {
  std::string name;
  StrTable uniq;
  std::vector<int32_t> per_row;
};

struct Handle {
  uint64_t rows = 0;
  std::vector<std::vector<double>> numeric;
  std::vector<Bag> bags;
  std::vector<Tag> tags;
  bool cap_uid = false;
  std::vector<char> uid_blob;
  std::vector<uint64_t> uid_offs{0};
  std::vector<uint8_t> uid_kind;  // 0 missing, 1 string, 2 long(decimal text)
  std::string err;
};

struct Op {
  uint32_t code, a, b, c;
};

// permutations of (name, term, value): position of each in field order
constexpr int kPerm[6][3] = {
    {0, 1, 2}, {0, 2, 1}, {1, 0, 2}, {2, 0, 1}, {1, 2, 0}, {2, 1, 0},
};

bool skip_kind(Reader& r, uint32_t kind) {
  switch (kind) {
    case 0: r.read_long(); return r.ok;
    case 1: r.read_double(); return r.ok;
    case 2: r.read_float(); return r.ok;
    case 3: r.skip_bytes_field(); return r.ok;
    case 4: return r.need(1) ? (r.p++, true) : false;
    case 5: return true;  // null
    case 6: {             // map<string>
      while (true) {
        int64_t cnt = r.read_long();
        if (!r.ok) return false;
        if (cnt == 0) break;
        if (cnt < 0) {
          r.read_long();  // byte size, unused
          cnt = -cnt;
        }
        for (int64_t i = 0; i < cnt && r.ok; i++) {
          r.skip_bytes_field();
          r.skip_bytes_field();
        }
      }
      return r.ok;
    }
    case 7: {  // array<NTV-shaped record: 2 strings + 1 numeric (8 bytes)>
      while (true) {
        int64_t cnt = r.read_long();
        if (!r.ok) return false;
        if (cnt == 0) break;
        if (cnt < 0) {
          r.read_long();
          cnt = -cnt;
        }
        for (int64_t i = 0; i < cnt && r.ok; i++) {
          r.skip_bytes_field();
          r.skip_bytes_field();
          r.read_double();
        }
      }
      return r.ok;
    }
    default: return false;
  }
}

// union prelude: returns true if the value is PRESENT (non-null branch)
bool union_present(Reader& r, uint32_t flags) {
  if (!(flags & 1)) return true;  // not a union
  int64_t branch = r.read_long();
  if (!r.ok) return false;
  int64_t null_branch = (flags & 2) ? 1 : 0;
  return branch != null_branch;
}

bool decode_record(Reader& r, const std::vector<Op>& ops, Handle* h,
                   const double* defaults) {
  for (const Op& op : ops) {
    switch (op.code) {
      case 0: return true;  // END
      case 1:
        if (!skip_kind(r, op.a)) return false;
        break;
      case 6:  // SKIPOPT
        if (union_present(r, op.c)) {
          if (!skip_kind(r, op.a)) return false;
        }
        break;
      case 2: {  // CAPNUM
        double v = defaults[op.a];
        if (union_present(r, op.c)) {
          if (op.b == 0) v = static_cast<double>(r.read_long());
          else if (op.b == 1) v = r.read_double();
          else v = static_cast<double>(r.read_float());
        }
        if (!r.ok) return false;
        h->numeric[op.a].push_back(v);
        break;
      }
      case 3: {  // BAG
        Bag& bag = h->bags[op.a];
        bool present = true;
        if (op.c & 2) {  // nullable outer union
          int64_t branch = r.read_long();
          if (!r.ok) return false;
          int64_t null_branch = (op.c & 4) ? 1 : 0;
          present = branch != null_branch;
        }
        if (present) {
          const int* perm = kPerm[op.b];
          while (true) {
            int64_t cnt = r.read_long();
            if (!r.ok) return false;
            if (cnt == 0) break;
            if (cnt < 0) {
              r.read_long();
              cnt = -cnt;
            }
            for (int64_t i = 0; i < cnt; i++) {
              const char* name = nullptr;
              const char* term = nullptr;
              uint64_t name_len = 0, term_len = 0;
              double value = 0.0;
              for (int f = 0; f < 3; f++) {
                if (perm[0] == f) name = r.read_bytes(&name_len);
                else if (perm[1] == f) term = r.read_bytes(&term_len);
                else value = (op.c & 1) ? static_cast<double>(r.read_float())
                                        : r.read_double();
              }
              if (!r.ok) return false;
              bag.keybuf.clear();
              if (op.c & 8) {  // pair keys
                char len[24];
                int w = std::snprintf(len, sizeof len, "%llu:",
                                      static_cast<unsigned long long>(name_len));
                bag.keybuf.insert(bag.keybuf.end(), len, len + w);
                bag.keybuf.insert(bag.keybuf.end(), name, name + name_len);
                bag.keybuf.insert(bag.keybuf.end(), term, term + term_len);
              } else {
                bag.keybuf.insert(bag.keybuf.end(), name, name + name_len);
                if (term_len) {
                  bag.keybuf.push_back(kDelimiter);
                  bag.keybuf.insert(bag.keybuf.end(), term, term + term_len);
                }
              }
              bag.ids.push_back(
                  bag.uniq.intern(bag.keybuf.data(), bag.keybuf.size()));
              bag.vals.push_back(static_cast<float>(value));
            }
          }
        }
        break;
      }
      case 4: {  // TAGMAP
        if (!union_present(r, op.c)) break;
        while (true) {
          int64_t cnt = r.read_long();
          if (!r.ok) return false;
          if (cnt == 0) break;
          if (cnt < 0) {
            r.read_long();
            cnt = -cnt;
          }
          for (int64_t i = 0; i < cnt; i++) {
            uint64_t klen, vlen;
            const char* key = r.read_bytes(&klen);
            if (!r.ok) return false;
            Tag* match = nullptr;
            for (Tag& t : h->tags)
              if (t.name.size() == klen &&
                  std::memcmp(t.name.data(), key, klen) == 0) {
                match = &t;
                break;
              }
            const char* val = r.read_bytes(&vlen);
            if (!r.ok) return false;
            if (match) match->per_row.back() = static_cast<int32_t>(
                match->uniq.intern(val, vlen));
          }
        }
        break;
      }
      case 5: {  // UID
        uint8_t kind = 0;
        if (op.c & 1) {  // union: [null, string(, long)]
          int64_t branch = r.read_long();
          if (!r.ok) return false;
          if (branch == 1) kind = 1;
          else if (branch == 2 && (op.c & 4)) kind = 2;
          else if (branch != 0) return false;
        } else {
          kind = 1;
        }
        if (h->cap_uid) {
          if (kind == 1) {
            uint64_t len;
            const char* s = r.read_bytes(&len);
            if (!r.ok) return false;
            h->uid_blob.insert(h->uid_blob.end(), s, s + len);
          } else if (kind == 2) {
            char buf[24];
            int n = std::snprintf(buf, sizeof(buf), "%lld",
                                  static_cast<long long>(r.read_long()));
            if (!r.ok) return false;
            h->uid_blob.insert(h->uid_blob.end(), buf, buf + n);
          }
          h->uid_offs.push_back(h->uid_blob.size());
          h->uid_kind.push_back(kind);
        } else {
          if (kind == 1) r.skip_bytes_field();
          else if (kind == 2) r.read_long();
          if (!r.ok) return false;
        }
        break;
      }
      default: return false;
    }
  }
  return true;
}

bool fail(Handle* h, const std::string& msg) {
  h->err = msg;
  return false;
}

bool ingest_file(Handle* h, const char* path, const std::vector<Op>& ops,
                 const double* defaults) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(h, "cannot open file");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(static_cast<size_t>(fsize));
  size_t got = std::fread(data.data(), 1, data.size(), f);
  std::fclose(f);
  if (got != data.size()) return fail(h, "short read");

  Reader r{data.data(), data.data() + data.size()};
  if (!r.need(4) || std::memcmp(r.p, "Obj\x01", 4) != 0)
    return fail(h, "not an avro container");
  r.p += 4;

  bool deflate = false;
  while (true) {  // metadata map
    int64_t cnt = r.read_long();
    if (!r.ok) return fail(h, "bad metadata");
    if (cnt == 0) break;
    if (cnt < 0) {
      r.read_long();
      cnt = -cnt;
    }
    for (int64_t i = 0; i < cnt; i++) {
      uint64_t klen, vlen;
      const char* key = r.read_bytes(&klen);
      if (!r.ok) return fail(h, "bad metadata key");
      const char* val = r.read_bytes(&vlen);
      if (!r.ok) return fail(h, "bad metadata value");
      if (klen == 10 && std::memcmp(key, "avro.codec", 10) == 0) {
        if (vlen == 7 && std::memcmp(val, "deflate", 7) == 0) deflate = true;
        else if (!(vlen == 4 && std::memcmp(val, "null", 4) == 0))
          return fail(h, "unsupported codec");
      }
    }
  }
  if (!r.need(16)) return fail(h, "missing sync marker");
  const uint8_t* sync = r.p;
  r.p += 16;

  std::vector<uint8_t> inflated;
  while (r.p < r.end) {
    int64_t cnt = r.read_long();
    int64_t size = r.read_long();
    if (!r.ok || size < 0 || !r.need(static_cast<size_t>(size)))
      return fail(h, "bad block header");
    Reader block{r.p, r.p + size};
    r.p += size;
    if (deflate) {
      inflated.clear();
      inflated.resize(static_cast<size_t>(size) * 4 + 1024);
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) return fail(h, "zlib init failed");
      zs.next_in = const_cast<uint8_t*>(block.p);
      zs.avail_in = static_cast<uInt>(size);
      size_t total = 0;
      int zret;
      do {
        if (total == inflated.size()) inflated.resize(inflated.size() * 2);
        zs.next_out = inflated.data() + total;
        zs.avail_out = static_cast<uInt>(inflated.size() - total);
        zret = inflate(&zs, Z_NO_FLUSH);
        total = inflated.size() - zs.avail_out;
      } while (zret == Z_OK);
      inflateEnd(&zs);
      if (zret != Z_STREAM_END) return fail(h, "zlib inflate failed");
      block = Reader{inflated.data(), inflated.data() + total};
    }
    for (int64_t i = 0; i < cnt; i++) {
      // per-row defaults that decode_record fills in lazily
      for (Tag& t : h->tags) t.per_row.push_back(-1);
      if (!decode_record(block, ops, h, defaults) || !block.ok)
        return fail(h, "record decode failed");
      for (Bag& b : h->bags) b.rowptr.push_back(static_cast<int64_t>(b.ids.size()));
      h->rows++;
    }
    if (!r.need(16) || std::memcmp(r.p, sync, 16) != 0)
      return fail(h, "sync marker mismatch (corrupt file)");
    r.p += 16;
  }
  return true;
}

}  // namespace

extern "C" {

void* pavro_ingest(const char* path, const uint32_t* ops_raw, uint32_t n_ops,
                   const double* defaults, uint32_t n_slots,
                   const char* tags_blob, const uint32_t* tag_lens,
                   uint32_t n_tags, uint32_t n_bags, int capture_uid,
                   char* errbuf, uint32_t errbuf_len) {
  Handle* h = new Handle();
  h->numeric.resize(n_slots);
  h->bags.resize(n_bags);
  h->cap_uid = capture_uid != 0;
  const char* tp = tags_blob;
  for (uint32_t i = 0; i < n_tags; i++) {
    Tag t;
    t.name.assign(tp, tag_lens[i]);
    tp += tag_lens[i];
    h->tags.push_back(std::move(t));
  }
  std::vector<Op> ops(n_ops);
  for (uint32_t i = 0; i < n_ops; i++)
    ops[i] = Op{ops_raw[i * 4], ops_raw[i * 4 + 1], ops_raw[i * 4 + 2],
                ops_raw[i * 4 + 3]};
  if (!ingest_file(h, path, ops, defaults)) {
    if (errbuf && errbuf_len) {
      std::snprintf(errbuf, errbuf_len, "%s", h->err.c_str());
    }
    delete h;
    return nullptr;
  }
  return h;
}

void pavro_free(void* hp) { delete static_cast<Handle*>(hp); }

uint64_t pavro_num_rows(void* hp) { return static_cast<Handle*>(hp)->rows; }

const double* pavro_numeric(void* hp, uint32_t slot) {
  return static_cast<Handle*>(hp)->numeric[slot].data();
}

uint64_t pavro_bag_nnz(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].ids.size();
}
const int64_t* pavro_bag_rowptr(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].rowptr.data();
}
const uint32_t* pavro_bag_ids(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].ids.data();
}
const float* pavro_bag_values(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].vals.data();
}
uint64_t pavro_bag_num_uniq(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].uniq.size();
}
const char* pavro_bag_uniq_blob(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].uniq.blob.data();
}
const uint64_t* pavro_bag_uniq_offsets(void* hp, uint32_t bag) {
  return static_cast<Handle*>(hp)->bags[bag].uniq.offs.data();
}

const int32_t* pavro_tag_ids(void* hp, uint32_t tag) {
  return static_cast<Handle*>(hp)->tags[tag].per_row.data();
}
uint64_t pavro_tag_num_uniq(void* hp, uint32_t tag) {
  return static_cast<Handle*>(hp)->tags[tag].uniq.size();
}
const char* pavro_tag_uniq_blob(void* hp, uint32_t tag) {
  return static_cast<Handle*>(hp)->tags[tag].uniq.blob.data();
}
const uint64_t* pavro_tag_uniq_offsets(void* hp, uint32_t tag) {
  return static_cast<Handle*>(hp)->tags[tag].uniq.offs.data();
}

const char* pavro_uid_blob(void* hp) {
  return static_cast<Handle*>(hp)->uid_blob.data();
}
const uint64_t* pavro_uid_offsets(void* hp) {
  return static_cast<Handle*>(hp)->uid_offs.data();
}
const uint8_t* pavro_uid_kinds(void* hp) {
  return static_cast<Handle*>(hp)->uid_kind.data();
}

}  // extern "C"
