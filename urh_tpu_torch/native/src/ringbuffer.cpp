// Lock-free SPSC ring buffer over caller-provided (shared) memory.
//
// Native counterpart of the Python RingBuffer (urh_tpu/util/ringbuffer.py)
// for the GIL-free IO data plane: one producer thread/process pushes
// interleaved IQ samples, one consumer pops them.  Indices use C++11
// atomics with acquire/release ordering; the buffer itself lives in
// caller-owned memory so it can be placed in POSIX shared memory.

#include <atomic>
#include <cstdint>
#include <cstring>

extern "C" {

struct RingState {
    std::atomic<uint64_t> head;  // write cursor (samples)
    std::atomic<uint64_t> tail;  // read cursor (samples)
    uint64_t capacity;           // capacity in samples (pairs of floats)
};

static_assert(sizeof(RingState) <= 64, "RingState must fit a cache line");

// Initialize a ring over `mem` with `capacity_samples` IQ samples.
// Layout: [RingState][float data (2 * capacity)]
void urh_ring_init(void *mem, uint64_t capacity_samples) {
    RingState *state = static_cast<RingState *>(mem);
    state->head.store(0, std::memory_order_relaxed);
    state->tail.store(0, std::memory_order_relaxed);
    state->capacity = capacity_samples;
}

uint64_t urh_ring_size_bytes(uint64_t capacity_samples) {
    return sizeof(RingState) + 2 * capacity_samples * sizeof(float);
}

static inline float *ring_data(RingState *state) {
    return reinterpret_cast<float *>(reinterpret_cast<char *>(state) + sizeof(RingState));
}

uint64_t urh_ring_len(void *mem) {
    RingState *state = static_cast<RingState *>(mem);
    return state->head.load(std::memory_order_acquire) -
           state->tail.load(std::memory_order_acquire);
}

uint64_t urh_ring_space(void *mem) {
    RingState *state = static_cast<RingState *>(mem);
    return state->capacity - urh_ring_len(mem);
}

// Push n samples (2n floats). Returns number of samples actually pushed.
uint64_t urh_ring_push(void *mem, const float *samples, uint64_t n) {
    RingState *state = static_cast<RingState *>(mem);
    const uint64_t capacity = state->capacity;
    const uint64_t head = state->head.load(std::memory_order_relaxed);
    const uint64_t tail = state->tail.load(std::memory_order_acquire);
    const uint64_t space = capacity - (head - tail);
    if (n > space) n = space;
    if (n == 0) return 0;

    float *data = ring_data(state);
    const uint64_t pos = head % capacity;
    const uint64_t first = (pos + n <= capacity) ? n : capacity - pos;

    std::memcpy(data + 2 * pos, samples, 2 * first * sizeof(float));
    if (n > first)
        std::memcpy(data, samples + 2 * first, 2 * (n - first) * sizeof(float));

    state->head.store(head + n, std::memory_order_release);
    return n;
}

// Pop up to n samples into out. Returns number of samples popped.
uint64_t urh_ring_pop(void *mem, float *out, uint64_t n) {
    RingState *state = static_cast<RingState *>(mem);
    const uint64_t capacity = state->capacity;
    const uint64_t head = state->head.load(std::memory_order_acquire);
    const uint64_t tail = state->tail.load(std::memory_order_relaxed);
    const uint64_t available = head - tail;
    if (n > available) n = available;
    if (n == 0) return 0;

    const float *data = ring_data(state);
    const uint64_t pos = tail % capacity;
    const uint64_t first = (pos + n <= capacity) ? n : capacity - pos;

    std::memcpy(out, data + 2 * pos, 2 * first * sizeof(float));
    if (n > first)
        std::memcpy(out + 2 * first, data, 2 * (n - first) * sizeof(float));

    state->tail.store(tail + n, std::memory_order_release);
    return n;
}

void urh_ring_clear(void *mem) {
    RingState *state = static_cast<RingState *>(mem);
    state->tail.store(state->head.load(std::memory_order_acquire),
                      std::memory_order_release);
}

}  // extern "C"
