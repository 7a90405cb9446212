// GIL-free TCP sample streaming.
//
// Native counterpart of the reference's per-device IO threads: a
// receiver thread accepts one TCP connection and streams raw float32
// IQ bytes straight into a native ring buffer (see ringbuffer.cpp)
// without ever touching the Python heap; a sender call drains a
// caller buffer to a socket.  Python drives lifecycle via ctypes.

#include <arpa/inet.h>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {
uint64_t urh_ring_push(void *mem, const float *samples, uint64_t n);
}

namespace {

struct Receiver {
    int listen_fd = -1;
    uint16_t port = 0;
    std::atomic<bool> running{false};
    std::thread worker;
    void *ring = nullptr;
    std::atomic<uint64_t> total_samples{0};
    std::atomic<uint64_t> dropped_samples{0};
};

void receive_loop(Receiver *rx) {
    std::vector<char> buffer(1 << 20);
    size_t leftover = 0;

    while (rx->running.load(std::memory_order_acquire)) {
        sockaddr_in addr{};
        socklen_t addrlen = sizeof(addr);
        int conn = accept(rx->listen_fd, reinterpret_cast<sockaddr *>(&addr), &addrlen);
        if (conn < 0) continue;

        int flag = 1;
        setsockopt(conn, IPPROTO_TCP, TCP_NODELAY, &flag, sizeof(flag));

        leftover = 0;
        while (rx->running.load(std::memory_order_acquire)) {
            ssize_t got = recv(conn, buffer.data() + leftover, buffer.size() - leftover, 0);
            if (got <= 0) break;

            size_t total = leftover + static_cast<size_t>(got);
            size_t n_samples = total / (2 * sizeof(float));
            const float *samples = reinterpret_cast<const float *>(buffer.data());

            uint64_t pushed = urh_ring_push(rx->ring, samples, n_samples);
            rx->total_samples.fetch_add(pushed, std::memory_order_relaxed);
            if (pushed < n_samples)
                rx->dropped_samples.fetch_add(n_samples - pushed, std::memory_order_relaxed);

            leftover = total - n_samples * 2 * sizeof(float);
            if (leftover)
                std::memmove(buffer.data(), buffer.data() + total - leftover, leftover);
        }
        close(conn);
    }
}

}  // namespace

extern "C" {

// Start a receiver on `port` (0 = pick free). Returns handle or nullptr.
void *urh_net_rx_start(void *ring_mem, uint16_t port) {
    Receiver *rx = new Receiver();
    rx->ring = ring_mem;

    rx->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    if (rx->listen_fd < 0) { delete rx; return nullptr; }

    int reuse = 1;
    setsockopt(rx->listen_fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));

    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(port);
    if (bind(rx->listen_fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) < 0 ||
        listen(rx->listen_fd, 4) < 0) {
        close(rx->listen_fd);
        delete rx;
        return nullptr;
    }

    socklen_t addrlen = sizeof(addr);
    getsockname(rx->listen_fd, reinterpret_cast<sockaddr *>(&addr), &addrlen);
    rx->port = ntohs(addr.sin_port);

    // accept() must wake when stopping: give it a timeout
    timeval tv{0, 200000};
    setsockopt(rx->listen_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

    rx->running.store(true, std::memory_order_release);
    rx->worker = std::thread(receive_loop, rx);
    return rx;
}

uint16_t urh_net_rx_port(void *handle) {
    return static_cast<Receiver *>(handle)->port;
}

uint64_t urh_net_rx_total_samples(void *handle) {
    return static_cast<Receiver *>(handle)->total_samples.load(std::memory_order_relaxed);
}

uint64_t urh_net_rx_dropped_samples(void *handle) {
    return static_cast<Receiver *>(handle)->dropped_samples.load(std::memory_order_relaxed);
}

void urh_net_rx_stop(void *handle) {
    Receiver *rx = static_cast<Receiver *>(handle);
    rx->running.store(false, std::memory_order_release);
    shutdown(rx->listen_fd, SHUT_RDWR);
    if (rx->worker.joinable()) rx->worker.join();
    close(rx->listen_fd);
    delete rx;
}

// Blocking send of 2n floats to host:port. Returns samples sent or -1.
int64_t urh_net_send(const char *host, uint16_t port, const float *samples, uint64_t n) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;

    int flag = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &flag, sizeof(flag));

    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (connect(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) < 0) {
        close(fd);
        return -1;
    }

    const char *data = reinterpret_cast<const char *>(samples);
    size_t remaining = 2 * n * sizeof(float);
    while (remaining > 0) {
        ssize_t sent = send(fd, data, remaining, 0);
        if (sent <= 0) { close(fd); return -1; }
        data += sent;
        remaining -= static_cast<size_t>(sent);
    }
    shutdown(fd, SHUT_RDWR);
    close(fd);
    return static_cast<int64_t>(n);
}

}  // extern "C"
