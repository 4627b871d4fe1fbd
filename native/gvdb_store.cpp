// gvdb_store — native append-only segment-log KV store with hash index.
//
// The framework's native storage engine: the role sled (embedded LSM KV)
// plays in the reference (storage.rs/advanced_storage.rs) — durable payload
// and metadata storage under the host-side document store. Design:
//
//   * one append-only data file per store ("segment log"): records framed as
//       [u32 klen][u32 vlen][u64 xxhash-ish checksum][key bytes][val bytes]
//     vlen == 0xFFFFFFFF marks a tombstone (delete).
//   * in-memory unordered_map<string, (offset, vlen)> index, rebuilt by a
//     sequential scan on open (torn tails are truncated — crash recovery).
//   * compact() rewrites live records to a fresh log and atomically renames.
//   * fsync on flush(); thread-safe via a single mutex (the Python layer
//     batches; lock contention is not the bottleneck).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t TOMBSTONE = 0xFFFFFFFFu;

// FNV-1a 64-bit — cheap integrity checksum for frames.
static uint64_t fnv1a(const uint8_t* data, size_t len, uint64_t seed) {
    uint64_t h = 1469598103934665603ull ^ seed;
    for (size_t i = 0; i < len; i++) {
        h ^= data[i];
        h *= 1099511628211ull;
    }
    return h;
}

struct Entry {
    uint64_t offset;  // offset of value bytes in file
    uint32_t vlen;
};

struct Store {
    std::mutex mu;
    std::string path;
    FILE* f = nullptr;
    std::unordered_map<std::string, Entry> index;
    uint64_t tail = 0;       // logical end of valid data
    uint64_t dead_bytes = 0; // garbage from overwrites/deletes

    ~Store() {
        if (f) fclose(f);
    }
};

struct FrameHeader {
    uint32_t klen;
    uint32_t vlen;
    uint64_t checksum;
};

static bool write_frame(Store* s, const std::string& key, const uint8_t* val,
                        uint32_t vlen_field, uint32_t vlen_real) {
    FrameHeader h;
    h.klen = (uint32_t)key.size();
    h.vlen = vlen_field;
    uint64_t ck = fnv1a((const uint8_t*)key.data(), key.size(), 0);
    if (vlen_field != TOMBSTONE && val != nullptr)
        ck = fnv1a(val, vlen_real, ck);
    h.checksum = ck;
    if (fseeko(s->f, (off_t)s->tail, SEEK_SET) != 0) return false;
    if (fwrite(&h, sizeof(h), 1, s->f) != 1) return false;
    if (fwrite(key.data(), 1, key.size(), s->f) != key.size()) return false;
    uint64_t voff = s->tail + sizeof(h) + key.size();
    if (vlen_field != TOMBSTONE && vlen_real > 0) {
        if (fwrite(val, 1, vlen_real, s->f) != vlen_real) return false;
    }
    s->tail = voff + (vlen_field == TOMBSTONE ? 0 : vlen_real);
    if (vlen_field == TOMBSTONE) {
        auto it = s->index.find(key);
        if (it != s->index.end()) {
            s->dead_bytes += it->second.vlen + sizeof(h) + key.size();
            s->index.erase(it);
        }
    } else {
        auto it = s->index.find(key);
        if (it != s->index.end())
            s->dead_bytes += it->second.vlen + sizeof(h) + key.size();
        s->index[key] = Entry{voff, vlen_real};
    }
    return true;
}

static void rebuild_index(Store* s) {
    s->index.clear();
    s->tail = 0;
    s->dead_bytes = 0;
    fseeko(s->f, 0, SEEK_END);
    uint64_t fsize = (uint64_t)ftello(s->f);
    fseeko(s->f, 0, SEEK_SET);
    std::vector<uint8_t> buf;
    uint64_t pos = 0;
    while (pos + sizeof(FrameHeader) <= fsize) {
        FrameHeader h;
        fseeko(s->f, (off_t)pos, SEEK_SET);
        if (fread(&h, sizeof(h), 1, s->f) != 1) break;
        uint64_t body = h.klen + (h.vlen == TOMBSTONE ? 0 : (uint64_t)h.vlen);
        if (pos + sizeof(h) + body > fsize) break;  // torn tail
        buf.resize(body);
        if (body && fread(buf.data(), 1, body, s->f) != body) break;
        uint64_t ck = fnv1a(buf.data(), h.klen, 0);
        if (h.vlen != TOMBSTONE)
            ck = fnv1a(buf.data() + h.klen, h.vlen, ck);
        if (ck != h.checksum) break;  // corrupt frame: stop (treat as tail)
        std::string key((const char*)buf.data(), h.klen);
        if (h.vlen == TOMBSTONE) {
            auto it = s->index.find(key);
            if (it != s->index.end()) s->index.erase(it);
        } else {
            s->index[key] = Entry{pos + sizeof(h) + h.klen, h.vlen};
        }
        pos += sizeof(h) + body;
    }
    s->tail = pos;
}

}  // namespace

extern "C" {

void* gvdb_open(const char* path) {
    Store* s = new Store();
    s->path = path;
    s->f = fopen(path, "r+b");
    if (!s->f) s->f = fopen(path, "w+b");
    if (!s->f) {
        delete s;
        return nullptr;
    }
    rebuild_index(s);
    return s;
}

int gvdb_put(void* hs, const uint8_t* key, uint32_t klen, const uint8_t* val,
             uint32_t vlen) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    std::string k((const char*)key, klen);
    return write_frame(s, k, val, vlen, vlen) ? 0 : -1;
}

// Returns value length, or -1 if missing. Copies into out (caller-sized via
// gvdb_get_len first, or big enough buffer).
int64_t gvdb_get_len(void* hs, const uint8_t* key, uint32_t klen) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->index.find(std::string((const char*)key, klen));
    if (it == s->index.end()) return -1;
    return (int64_t)it->second.vlen;
}

int64_t gvdb_get(void* hs, const uint8_t* key, uint32_t klen, uint8_t* out,
                 uint32_t out_cap) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->index.find(std::string((const char*)key, klen));
    if (it == s->index.end()) return -1;
    if (it->second.vlen > out_cap) return -2;
    fseeko(s->f, (off_t)it->second.offset, SEEK_SET);
    if (fread(out, 1, it->second.vlen, s->f) != it->second.vlen) return -3;
    return (int64_t)it->second.vlen;
}

int gvdb_delete(void* hs, const uint8_t* key, uint32_t klen) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    std::string k((const char*)key, klen);
    if (s->index.find(k) == s->index.end()) return 1;  // not found
    return write_frame(s, k, nullptr, TOMBSTONE, 0) ? 0 : -1;
}

uint64_t gvdb_count(void* hs) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    return (uint64_t)s->index.size();
}

uint64_t gvdb_dead_bytes(void* hs) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    return s->dead_bytes;
}

int gvdb_flush(void* hs) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    if (fflush(s->f) != 0) return -1;
    return fsync(fileno(s->f)) == 0 ? 0 : -1;
}

// Iterate keys: fills out with length-prefixed keys ([u32 len][bytes]...) so
// arbitrary key bytes (including newlines) round-trip. Returns bytes written,
// or -needed if out_cap is too small.
int64_t gvdb_keys(void* hs, uint8_t* out, uint64_t out_cap) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    uint64_t need = 0;
    for (auto& kv : s->index) need += 4 + kv.first.size();
    if (need > out_cap) return -(int64_t)need;
    uint64_t w = 0;
    for (auto& kv : s->index) {
        uint32_t len = (uint32_t)kv.first.size();
        memcpy(out + w, &len, 4);
        w += 4;
        memcpy(out + w, kv.first.data(), kv.first.size());
        w += kv.first.size();
    }
    return (int64_t)w;
}

int gvdb_compact(void* hs) {
    Store* s = (Store*)hs;
    std::lock_guard<std::mutex> g(s->mu);
    std::string tmp = s->path + ".compact";
    FILE* nf = fopen(tmp.c_str(), "w+b");
    if (!nf) return -1;
    // stream live records to the new file
    std::unordered_map<std::string, Entry> new_index;
    uint64_t ntail = 0;
    std::vector<uint8_t> vbuf;
    for (auto& kv : s->index) {
        vbuf.resize(kv.second.vlen);
        fseeko(s->f, (off_t)kv.second.offset, SEEK_SET);
        if (kv.second.vlen &&
            fread(vbuf.data(), 1, kv.second.vlen, s->f) != kv.second.vlen) {
            fclose(nf);
            remove(tmp.c_str());
            return -2;
        }
        FrameHeader h;
        h.klen = (uint32_t)kv.first.size();
        h.vlen = kv.second.vlen;
        uint64_t ck = fnv1a((const uint8_t*)kv.first.data(), kv.first.size(), 0);
        ck = fnv1a(vbuf.data(), kv.second.vlen, ck);
        h.checksum = ck;
        fwrite(&h, sizeof(h), 1, nf);
        fwrite(kv.first.data(), 1, kv.first.size(), nf);
        uint64_t voff = ntail + sizeof(h) + kv.first.size();
        fwrite(vbuf.data(), 1, kv.second.vlen, nf);
        new_index[kv.first] = Entry{voff, kv.second.vlen};
        ntail = voff + kv.second.vlen;
    }
    fflush(nf);
    fsync(fileno(nf));
    fclose(s->f);
    fclose(nf);
    if (rename(tmp.c_str(), s->path.c_str()) != 0) {
        s->f = fopen(s->path.c_str(), "r+b");
        return -3;
    }
    s->f = fopen(s->path.c_str(), "r+b");
    s->index = std::move(new_index);
    s->tail = ntail;
    s->dead_bytes = 0;
    return 0;
}

void gvdb_close(void* hs) {
    Store* s = (Store*)hs;
    {
        std::lock_guard<std::mutex> g(s->mu);
        if (s->f) {
            fflush(s->f);
            fsync(fileno(s->f));
        }
    }
    delete s;
}

}  // extern "C"
