// halide_tpu_torch native host runtime: binary trace packet writer + LRU
// memoization cache.
//
// The host-side remainder of the reference's freestanding runtime pieces
// (reference: src/runtime/tracing.cpp — halide_trace_event packets to
// HL_TRACE_FILE; src/runtime/cache.cpp — halide_memoization_cache_* LRU).
// Device compute belongs to torch and the port's CUDA kernels; what remains
// native on the host is exactly this: observability streams and host-side
// result caching, shared by every pipeline in the process. Exposed through
// a C ABI consumed via ctypes (built with g++ by ops/build.load_host; the
// packet layout and the cache are those of the JAX package's runtime).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// trace stream
// ---------------------------------------------------------------------------

// packet layout (little endian), mirroring the spirit of
// halide_trace_event_t: fixed header + func name + payload bytes
struct ht_trace_packet_header {
    uint32_t magic;        // 'HTRC'
    uint32_t event_code;   // 0 load, 1 store, 2 begin_realization,
                           // 3 end_realization, 4 produce, 5 consume,
                           // 6 print
    uint32_t name_len;
    uint32_t payload_len;
    uint32_t dtype_code;
    uint32_t dims;
    int32_t  coords[8];
};

static std::mutex trace_mutex;
static FILE *trace_file = nullptr;
static uint64_t trace_packets = 0;
static uint64_t trace_bytes = 0;

int ht_trace_open(const char *path) {
    std::lock_guard<std::mutex> lock(trace_mutex);
    if (trace_file) fclose(trace_file);
    trace_file = fopen(path, "wb");
    trace_packets = 0;
    trace_bytes = 0;
    return trace_file ? 0 : -1;
}

int ht_trace_emit(uint32_t event_code, const char *name, uint32_t dtype_code,
                  uint32_t dims, const int32_t *coords,
                  const uint8_t *payload, uint32_t payload_len) {
    std::lock_guard<std::mutex> lock(trace_mutex);
    ht_trace_packet_header h;
    memset(&h, 0, sizeof(h));
    h.magic = 0x48545243u;  // 'HTRC'
    h.event_code = event_code;
    h.name_len = (uint32_t)strlen(name);
    h.payload_len = payload_len;
    h.dtype_code = dtype_code;
    h.dims = dims > 8 ? 8 : dims;
    for (uint32_t i = 0; i < h.dims; i++) h.coords[i] = coords[i];
    trace_packets++;
    trace_bytes += sizeof(h) + h.name_len + payload_len;
    if (!trace_file) return 0;  // counting-only mode
    if (fwrite(&h, sizeof(h), 1, trace_file) != 1) return -1;
    if (h.name_len && fwrite(name, 1, h.name_len, trace_file) != h.name_len)
        return -1;
    if (payload_len &&
        fwrite(payload, 1, payload_len, trace_file) != payload_len)
        return -1;
    return 0;
}

uint64_t ht_trace_packet_count() { return trace_packets; }
uint64_t ht_trace_byte_count() { return trace_bytes; }

int ht_trace_close() {
    std::lock_guard<std::mutex> lock(trace_mutex);
    if (trace_file) {
        fclose(trace_file);
        trace_file = nullptr;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// LRU memoization cache (reference: src/runtime/cache.cpp:239 LRU eviction)
// ---------------------------------------------------------------------------

struct CacheEntry {
    std::string key;
    std::vector<uint8_t> value;
};

static std::mutex cache_mutex;
static std::list<CacheEntry> cache_lru;  // front = most recent
static std::unordered_map<std::string, std::list<CacheEntry>::iterator>
    cache_map;
static size_t cache_capacity = 1u << 30;
static size_t cache_size = 0;
static uint64_t cache_hits = 0, cache_misses = 0, cache_evictions = 0;

void ht_cache_set_size(uint64_t bytes) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    cache_capacity = (size_t)bytes;
}

static void evict_locked() {
    while (cache_size > cache_capacity && !cache_lru.empty()) {
        CacheEntry &back = cache_lru.back();
        cache_size -= back.value.size();
        cache_map.erase(back.key);
        cache_lru.pop_back();
        cache_evictions++;
    }
}

int ht_cache_store(const uint8_t *key, uint32_t key_len,
                   const uint8_t *value, uint64_t value_len) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    std::string k((const char *)key, key_len);
    auto it = cache_map.find(k);
    if (it != cache_map.end()) {
        cache_size -= it->second->value.size();
        cache_lru.erase(it->second);
        cache_map.erase(it);
    }
    cache_lru.push_front(CacheEntry{k, std::vector<uint8_t>(
        value, value + value_len)});
    cache_map[k] = cache_lru.begin();
    cache_size += (size_t)value_len;
    evict_locked();
    return 0;
}

// returns value size on hit (and copies up to buf_len bytes), -1 on miss
int64_t ht_cache_lookup(const uint8_t *key, uint32_t key_len,
                        uint8_t *buf, uint64_t buf_len) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    std::string k((const char *)key, key_len);
    auto it = cache_map.find(k);
    if (it == cache_map.end()) {
        cache_misses++;
        return -1;
    }
    cache_hits++;
    // move to front
    cache_lru.splice(cache_lru.begin(), cache_lru, it->second);
    const std::vector<uint8_t> &v = it->second->value;
    uint64_t n = v.size() < buf_len ? v.size() : buf_len;
    if (buf && n) memcpy(buf, v.data(), n);
    return (int64_t)v.size();
}

void ht_cache_stats(uint64_t *hits, uint64_t *misses, uint64_t *evictions,
                    uint64_t *bytes, uint64_t *entries) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    *hits = cache_hits;
    *misses = cache_misses;
    *evictions = cache_evictions;
    *bytes = cache_size;
    *entries = cache_lru.size();
}

void ht_cache_clear() {
    std::lock_guard<std::mutex> lock(cache_mutex);
    cache_lru.clear();
    cache_map.clear();
    cache_size = 0;
}

}  // extern "C"
