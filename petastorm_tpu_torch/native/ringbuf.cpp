// Single-producer/single-consumer shared-memory ring buffer.
//
// A copy of the JAX package's ring (petastorm_tpu/native/ringbuf.cpp): the
// record layout is the same byte for byte, so either package's producer can
// feed the other's consumer. The process pool's data plane: each worker
// process owns one ring (worker -> consumer) backed by POSIX shared memory.
// Messages are length-prefixed and contiguous (a wrap marker skips the tail
// padding), so the consumer can hand Python a zero-copy view of the mapped
// payload and advance the read cursor only after deserialization. It takes
// the place of the reference's ZeroMQ transport
// (petastorm/workers_pool/process_pool.py:53).
//
// Memory layout:
//   [RingHeader (64B)] [data region of `capacity` bytes]
// RingHeader: head u64 | tail u64 | capacity u64 | closed u32 | pad u32 |
// waiting u64 | pad. `waiting` is the record size (aligned, with its length
// word) the producer is blocked on for want of space, else 0: the consumer
// reads it to tell a producer held back by records it still views from one
// that is busy.
// Records in the data region:
//   [uint32 len][payload bytes], 8-byte aligned
//   len == WRAP_MARKER means "skip to region start".
//
// Synchronization: head (producer cursor) and tail (consumer cursor) are
// C++11 atomics in shared memory; release/acquire ordering makes payload
// writes visible before the head moves. Blocking ops spin with
// nanosleep(50us) — latency is dominated by row-group decode times (ms), so
// futexes are not worth the portability cost.
//
// Build (native/__init__.py does it at first use, into build/torch_native/):
// g++ -O2 -shared -fPIC -std=c++17 ringbuf.cpp -o libptring.so -lrt

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t WRAP_MARKER = 0xFFFFFFFFu;
constexpr uint64_t ALIGN = 8;

struct RingHeader {
    std::atomic<uint64_t> head;   // next write offset (mod capacity window)
    std::atomic<uint64_t> tail;   // next read offset
    uint64_t capacity;
    std::atomic<uint32_t> closed; // producer signaled end-of-stream
    uint32_t _pad0;
    std::atomic<uint64_t> waiting; // bytes of the record the producer waits to write
    uint32_t _pad[6];
};
static_assert(sizeof(RingHeader) == 64, "header must stay one cache line");

struct Ring {
    RingHeader* hdr;
    uint8_t* data;
    uint64_t map_len;
    int owner;  // created (1) vs attached (0)
    char name[256];
};

inline uint64_t align_up(uint64_t v) { return (v + ALIGN - 1) & ~(ALIGN - 1); }

void sleep_us(long usec) {
    timespec ts{0, usec * 1000L};
    nanosleep(&ts, nullptr);
}

long now_ms() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000L + ts.tv_nsec / 1000000L;
}

}  // namespace

extern "C" {

// Create (owner=1) or attach (owner=0) a ring. Returns nullptr on failure.
void* pt_ring_open(const char* name, uint64_t capacity, int owner) {
    int flags = owner ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
    int fd = shm_open(name, flags, 0600);
    if (fd < 0) return nullptr;

    uint64_t map_len = sizeof(RingHeader) + capacity;
    if (owner) {
        if (ftruncate(fd, (off_t)map_len) != 0) {
            close(fd);
            shm_unlink(name);
            return nullptr;
        }
    } else {
        struct stat st;
        if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(RingHeader)) {
            close(fd);
            return nullptr;
        }
        map_len = (uint64_t)st.st_size;
        capacity = map_len - sizeof(RingHeader);
    }

    void* mem = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;

    Ring* ring = new Ring();
    ring->hdr = reinterpret_cast<RingHeader*>(mem);
    ring->data = reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader);
    ring->map_len = map_len;
    ring->owner = owner;
    strncpy(ring->name, name, sizeof(ring->name) - 1);

    if (owner) {
        ring->hdr->head.store(0, std::memory_order_relaxed);
        ring->hdr->tail.store(0, std::memory_order_relaxed);
        ring->hdr->closed.store(0, std::memory_order_relaxed);
        ring->hdr->waiting.store(0, std::memory_order_relaxed);
        ring->hdr->capacity = capacity;
    }
    return ring;
}

uint64_t pt_ring_capacity(void* handle) {
    return reinterpret_cast<Ring*>(handle)->hdr->capacity;
}

// Base address of the mapped data region (for zero-copy python memoryview).
void* pt_ring_data_ptr(void* handle) {
    return reinterpret_cast<Ring*>(handle)->data;
}

// Write one message. Returns 0 on success, -1 on timeout, -2 if the message
// can never fit, -3 if the ring is closed.
int pt_ring_write(void* handle, const void* payload, uint32_t len, int timeout_ms) {
    Ring* r = reinterpret_cast<Ring*>(handle);
    RingHeader* h = r->hdr;
    const uint64_t cap = h->capacity;
    const uint64_t need = align_up(4 + (uint64_t)len);
    // Worst-case a record consumes `contiguous + need` (< 2*need) bytes when
    // it wraps; requiring 2*need <= cap guarantees an empty ring can always
    // accept it (no deadlock on oversized-but-"fitting" payloads).
    if (need * 2 > cap) return -2;

    long deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : -1;
    for (;;) {
        if (h->closed.load(std::memory_order_acquire)) {
            h->waiting.store(0, std::memory_order_relaxed);
            return -3;
        }
        uint64_t head = h->head.load(std::memory_order_relaxed);
        uint64_t tail = h->tail.load(std::memory_order_acquire);
        uint64_t used = head - tail;
        uint64_t pos = head % cap;
        uint64_t contiguous = cap - pos;

        // If the record doesn't fit before the wrap point, we must write a
        // wrap marker and start at 0 — account for the skipped space too.
        uint64_t total = (contiguous >= need) ? need : contiguous + need;
        if (cap - used >= total) {
            if (contiguous < need) {
                if (contiguous >= 4) {
                    uint32_t marker = WRAP_MARKER;
                    memcpy(r->data + pos, &marker, 4);
                }
                head += contiguous;
                pos = 0;
            }
            memcpy(r->data + pos, &len, 4);
            memcpy(r->data + pos + 4, payload, len);
            h->waiting.store(0, std::memory_order_relaxed);
            h->head.store(head + need, std::memory_order_release);
            return 0;
        }
        h->waiting.store(need, std::memory_order_release);
        if (deadline >= 0 && now_ms() > deadline) {
            h->waiting.store(0, std::memory_order_relaxed);
            return -1;
        }
        sleep_us(50);
    }
}

// Write one message consisting of a 1-byte kind tag followed by the payload
// (saves the caller a full prefix-concat copy). Same returns as
// pt_ring_write.
int pt_ring_write2(void* handle, uint8_t kind, const void* payload, uint32_t len,
                   int timeout_ms) {
    Ring* r = reinterpret_cast<Ring*>(handle);
    RingHeader* h = r->hdr;
    const uint64_t cap = h->capacity;
    const uint64_t msg_len = 1 + (uint64_t)len;
    const uint64_t need = align_up(4 + msg_len);
    if (need * 2 > cap) return -2;  // see pt_ring_write deadlock note

    long deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : -1;
    for (;;) {
        if (h->closed.load(std::memory_order_acquire)) {
            h->waiting.store(0, std::memory_order_relaxed);
            return -3;
        }
        uint64_t head = h->head.load(std::memory_order_relaxed);
        uint64_t tail = h->tail.load(std::memory_order_acquire);
        uint64_t used = head - tail;
        uint64_t pos = head % cap;
        uint64_t contiguous = cap - pos;
        uint64_t total = (contiguous >= need) ? need : contiguous + need;
        if (cap - used >= total) {
            if (contiguous < need) {
                if (contiguous >= 4) {
                    uint32_t marker = WRAP_MARKER;
                    memcpy(r->data + pos, &marker, 4);
                }
                head += contiguous;
                pos = 0;
            }
            uint32_t len32 = (uint32_t)msg_len;
            memcpy(r->data + pos, &len32, 4);
            r->data[pos + 4] = kind;
            memcpy(r->data + pos + 5, payload, len);
            h->waiting.store(0, std::memory_order_relaxed);
            h->head.store(head + need, std::memory_order_release);
            return 0;
        }
        h->waiting.store(need, std::memory_order_release);
        if (deadline >= 0 && now_ms() > deadline) {
            h->waiting.store(0, std::memory_order_relaxed);
            return -1;
        }
        sleep_us(50);
    }
}

// Peek the next message without consuming: sets *offset (into the data
// region) and *len. Returns 0 on success, -1 on timeout, -3 if closed and
// drained.
int pt_ring_peek(void* handle, uint64_t* offset, uint32_t* len, int timeout_ms) {
    Ring* r = reinterpret_cast<Ring*>(handle);
    RingHeader* h = r->hdr;
    const uint64_t cap = h->capacity;

    long deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : -1;
    for (;;) {
        uint64_t tail = h->tail.load(std::memory_order_relaxed);
        uint64_t head = h->head.load(std::memory_order_acquire);
        if (head != tail) {
            uint64_t pos = tail % cap;
            uint64_t contiguous = cap - pos;
            uint32_t msg_len;
            if (contiguous < 4) {
                // Producer wrapped without room for a marker; skip to start.
                h->tail.store(tail + contiguous, std::memory_order_release);
                continue;
            }
            memcpy(&msg_len, r->data + pos, 4);
            if (msg_len == WRAP_MARKER) {
                h->tail.store(tail + contiguous, std::memory_order_release);
                continue;
            }
            *offset = pos + 4;
            *len = msg_len;
            return 0;
        }
        if (h->closed.load(std::memory_order_acquire)) return -3;
        if (deadline >= 0 && now_ms() > deadline) return -1;
        sleep_us(50);
    }
}

// Consume the message previously peeked.
void pt_ring_advance(void* handle) {
    Ring* r = reinterpret_cast<Ring*>(handle);
    RingHeader* h = r->hdr;
    const uint64_t cap = h->capacity;
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t pos = tail % cap;
    uint32_t msg_len;
    memcpy(&msg_len, r->data + pos, 4);
    h->tail.store(tail + align_up(4 + (uint64_t)msg_len), std::memory_order_release);
}

// Convenience: read into a caller buffer (copies). Returns payload length,
// -1 timeout, -2 buffer too small (nothing consumed), -3 closed+drained.
long pt_ring_read(void* handle, void* buf, uint64_t buf_len, int timeout_ms) {
    uint64_t offset;
    uint32_t len;
    int rc = pt_ring_peek(handle, &offset, &len, timeout_ms);
    if (rc != 0) return rc;
    if (len > buf_len) return -2;
    Ring* r = reinterpret_cast<Ring*>(handle);
    memcpy(buf, r->data + offset, len);
    pt_ring_advance(handle);
    return (long)len;
}

void pt_ring_close_producer(void* handle) {
    reinterpret_cast<Ring*>(handle)->hdr->closed.store(1, std::memory_order_release);
}

void pt_ring_free(void* handle, int unlink) {
    Ring* r = reinterpret_cast<Ring*>(handle);
    munmap(reinterpret_cast<void*>(r->hdr), r->map_len);
    if (unlink) shm_unlink(r->name);
    delete r;
}

// Unlink the shm name WITHOUT unmapping: used when the consumer must leak a
// mapping because zero-copy views into it are still live (the kernel object
// is then freed with the last mapping, not before).
int pt_ring_unlink(const char* name) {
    return shm_unlink(name);
}

// Raw cursor access for the consumer-side multi-record reader
// (reader_impl/shm_ring.py RingReader): the consumer walks records FORWARD
// of the release point with its own cursor and publishes the release point
// itself via pt_ring_set_tail — which lets several records be outstanding
// (each pinned by a zero-copy segment claim) while memory is still released
// strictly in order.
uint64_t pt_ring_head(void* handle) {
    return reinterpret_cast<Ring*>(handle)->hdr->head.load(std::memory_order_acquire);
}

uint64_t pt_ring_tail(void* handle) {
    return reinterpret_cast<Ring*>(handle)->hdr->tail.load(std::memory_order_relaxed);
}

void pt_ring_set_tail(void* handle, uint64_t tail) {
    reinterpret_cast<Ring*>(handle)->hdr->tail.store(tail, std::memory_order_release);
}

int pt_ring_closed(void* handle) {
    return (int)reinterpret_cast<Ring*>(handle)->hdr->closed.load(std::memory_order_acquire);
}

uint64_t pt_ring_waiting(void* handle) {
    return reinterpret_cast<Ring*>(handle)->hdr->waiting.load(std::memory_order_acquire);
}

}  // extern "C"
