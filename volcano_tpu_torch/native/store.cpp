// The native object store: the C++ core of the in-process API server,
// volcano_tpu_torch's own copy of the JAX package's native/store.cpp.
//
// A thread-safe, resource-versioned KV store of opaque serialized objects
// with a bounded watch-event log, so informer-style consumers replay from
// a resourceVersion: the etcd state and watch streams behind Kubernetes'
// API server. Values are opaque bytes (the etcd model): Python serializes
// the objects and runs admission in front, as webhooks sit in front of
// etcd writes.
//
// C ABI (bound with ctypes; no C++ type crosses the boundary):
//   vs_new/vs_free            store lifecycle
//   vs_put                    create/update, bumps the global rv
//   vs_put_cas                compare-and-swap put
//   vs_get/vs_get_rv          point read (two-phase sizing)
//   vs_delete                 delete, logged with the last state
//   vs_list_keys              newline-joined keys of a kind
//   vs_count                  object count of a kind
//   vs_events_since           serialized event batch after a given rv
//   vs_rv                     current resourceVersion
//   vs_trimmed_rv             rv of the newest event the log dropped
//
// Build (native/__init__.py does it at first use):
//   g++ -O2 -shared -fPIC -std=c++17 store.cpp -o store.so

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Entry {
    std::string data;
    int64_t rv = 0;
};

enum EventType : int32_t { EV_ADDED = 0, EV_UPDATED = 1, EV_DELETED = 2 };

struct Event {
    int64_t rv;
    int32_t type;
    std::string kind;
    std::string key;
    std::string data;      // new object bytes ("" for delete uses old)
    std::string old_data;  // previous object bytes ("" on add)
};

struct Store {
    std::mutex mu;
    std::map<std::string, std::map<std::string, Entry>> kinds;
    std::deque<Event> log;
    size_t log_cap;
    int64_t rv = 0;
    int64_t trimmed_rv = 0;  // a resume from below it has lost events

    explicit Store(size_t cap) : log_cap(cap) {}

    void push_event(Event&& ev) {
        log.push_back(std::move(ev));
        while (log.size() > log_cap) {
            trimmed_rv = log.front().rv;
            log.pop_front();
        }
    }
};

// append a length-prefixed blob: [u32 len][bytes]
void put_blob(std::string& out, const std::string& s) {
    uint32_t n = static_cast<uint32_t>(s.size());
    out.append(reinterpret_cast<const char*>(&n), 4);
    out.append(s);
}

void put_i64(std::string& out, int64_t v) {
    out.append(reinterpret_cast<const char*>(&v), 8);
}

void put_i32(std::string& out, int32_t v) {
    out.append(reinterpret_cast<const char*>(&v), 4);
}

}  // namespace

extern "C" {

void* vs_new(int64_t log_capacity) {
    return new Store(log_capacity > 0 ? static_cast<size_t>(log_capacity)
                                      : 8192);
}

void vs_free(void* h) { delete static_cast<Store*>(h); }

int64_t vs_rv(void* h) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    return s->rv;
}

int64_t vs_trimmed_rv(void* h) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    return s->trimmed_rv;
}

// Compare-and-swap put (the optimistic-concurrency write k8s clients use:
// update fails unless metadata.resourceVersion matches the read).
//   expected_rv < 0 : unconditional update/create (same as vs_put)
//   expected_rv == 0: create-only — conflict if the key exists
//   expected_rv > 0 : key must exist with exactly this rv
// Returns the new rv, or -2 on conflict.
int64_t vs_put_cas(void* h, const char* kind, const char* key,
                   const char* data, int64_t len, int64_t expected_rv) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto& m = s->kinds[kind];
    auto it = m.find(key);
    if (expected_rv == 0 && it != m.end()) return -2;
    if (expected_rv > 0 &&
        (it == m.end() || it->second.rv != expected_rv)) return -2;
    Event ev;
    ev.type = (it == m.end()) ? EV_ADDED : EV_UPDATED;
    if (it != m.end()) ev.old_data = it->second.data;
    s->rv += 1;
    Entry e;
    e.data.assign(data, static_cast<size_t>(len));
    e.rv = s->rv;
    ev.rv = s->rv;
    ev.kind = kind;
    ev.key = key;
    ev.data = e.data;
    m[key] = std::move(e);
    s->push_event(std::move(ev));
    return s->rv;
}

// create_only=1: fail (-1) if the key exists. Returns the new rv.
int64_t vs_put(void* h, const char* kind, const char* key,
               const char* data, int64_t len, int32_t create_only) {
    int64_t rv = vs_put_cas(h, kind, key, data, len, create_only ? 0 : -1);
    return rv == -2 ? -1 : rv;
}

// Two-phase read: returns needed length, copies min(buflen, len) bytes.
// -1 when the key is absent.
int64_t vs_get(void* h, const char* kind, const char* key,
               char* buf, int64_t buflen) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto ki = s->kinds.find(kind);
    if (ki == s->kinds.end()) return -1;
    auto it = ki->second.find(key);
    if (it == ki->second.end()) return -1;
    const std::string& d = it->second.data;
    int64_t n = static_cast<int64_t>(d.size());
    if (buf && buflen > 0)
        std::memcpy(buf, d.data(), static_cast<size_t>(std::min(n, buflen)));
    return n;
}

int64_t vs_get_rv(void* h, const char* kind, const char* key) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto ki = s->kinds.find(kind);
    if (ki == s->kinds.end()) return -1;
    auto it = ki->second.find(key);
    return it == ki->second.end() ? -1 : it->second.rv;
}

// Returns the rv of the deletion, or -1 if absent. The DELETED event
// carries `data` (len bytes) as the object's last state when data is not
// null (an eviction's conditioned pod), else the stored bytes.
int64_t vs_delete(void* h, const char* kind, const char* key,
                  const char* data, int64_t len) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto ki = s->kinds.find(kind);
    if (ki == s->kinds.end()) return -1;
    auto it = ki->second.find(key);
    if (it == ki->second.end()) return -1;
    s->rv += 1;
    Event ev;
    ev.rv = s->rv;
    ev.type = EV_DELETED;
    ev.kind = kind;
    ev.key = key;
    if (data)
        ev.old_data.assign(data, static_cast<size_t>(len));
    else
        ev.old_data = it->second.data;
    ki->second.erase(it);
    s->push_event(std::move(ev));
    return s->rv;
}

int64_t vs_count(void* h, const char* kind) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    auto ki = s->kinds.find(kind);
    return ki == s->kinds.end() ? 0
                                : static_cast<int64_t>(ki->second.size());
}

// Newline-joined keys; two-phase sizing like vs_get.
int64_t vs_list_keys(void* h, const char* kind, char* buf, int64_t buflen) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    std::string out;
    auto ki = s->kinds.find(kind);
    if (ki != s->kinds.end()) {
        for (auto& kv : ki->second) {
            out.append(kv.first);
            out.push_back('\n');
        }
    }
    int64_t n = static_cast<int64_t>(out.size());
    if (buf && buflen > 0)
        std::memcpy(buf, out.data(),
                    static_cast<size_t>(std::min(n, buflen)));
    return n;
}

// Events with rv > since, serialized as:
//   [u32 count] then per event:
//   [i64 rv][i32 type][blob kind][blob key][blob data][blob old_data]
// Two-phase sizing: with buf == null, returns the bytes currently needed.
// With a buffer, only COMPLETE events that fit are serialized and the
// count header matches exactly — concurrent writers may append events
// between the sizing and fetch calls, so the fetch must never promise
// more than it delivers; callers drain in a loop until a batch is empty.
// If `since` is older than the log window, the batch starts at the window
// head (caller detects the gap via the first rv).
int64_t vs_events_since(void* h, int64_t since, char* buf, int64_t buflen) {
    Store* s = static_cast<Store*>(h);
    std::lock_guard<std::mutex> g(s->mu);
    uint32_t count = 0;
    std::string body;
    for (const Event& ev : s->log) {
        if (ev.rv <= since) continue;
        std::string one;
        put_i64(one, ev.rv);
        put_i32(one, ev.type);
        put_blob(one, ev.kind);
        put_blob(one, ev.key);
        put_blob(one, ev.data);
        put_blob(one, ev.old_data);
        if (buf && 4 + static_cast<int64_t>(body.size() + one.size())
                       > buflen)
            break;
        body.append(one);
        count += 1;
    }
    std::string out;
    out.append(reinterpret_cast<const char*>(&count), 4);
    out.append(body);
    int64_t n = static_cast<int64_t>(out.size());
    if (buf && buflen > 0)
        std::memcpy(buf, out.data(),
                    static_cast<size_t>(std::min(n, buflen)));
    return n;
}

}  // extern "C"
