// tpusdr_io — native host-side runtime of the SDR framework.
//
// The reference implements its entire sample-acquisition runtime in native
// code (Rust): a blocking reader thread feeding a bounded channel
// (/root/reference/examples/simple_fm.rs:55-132) and an rtl_tcp server with
// a bounded 500-block queue (/root/reference/examples/rtl_tcp.rs:24,365).
// This module is the framework's native equivalent: a fixed-block ring
// buffer with backpressure + drop accounting, a file/socket reader pump
// thread, and the hot byte-path conversions (u8 I/Q -> planar f32 with fs/4
// rotation, f32 -> s16 PCM, test-pattern continuity checking) that sit on
// the host side of the host->device boundary.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>

#include <poll.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// Fixed-block ring buffer (bounded queue semantics of rtl_tcp.rs:365)
// ---------------------------------------------------------------------------

struct Ring {
    uint8_t* arena = nullptr;
    size_t block_bytes = 0;
    size_t capacity = 0;  // blocks
    size_t head = 0;      // next write slot
    size_t tail = 0;      // next read slot
    size_t count = 0;     // filled blocks
    uint64_t dropped = 0;
    bool eof = false;
    std::mutex mu;
    std::condition_variable cv_push;  // signalled when a slot frees up
    std::condition_variable cv_pop;   // signalled when a block (or EOF) arrives
};

struct Pump {
    Ring* ring = nullptr;
    int fd = -1;
    bool loop_file = false;
    bool block_on_full = false;
    std::atomic<bool> stop{false};
    std::thread thread;
    uint64_t blocks_read = 0;
};

void pump_main(Pump* p) {
    Ring* r = p->ring;
    const size_t n = r->block_bytes;
    uint8_t* buf = new uint8_t[n];
    while (!p->stop.load(std::memory_order_relaxed)) {
        size_t got = 0;
        while (got < n) {
            ssize_t k = ::read(p->fd, buf + got, n - got);
            if (k > 0) {
                got += static_cast<size_t>(k);
            } else if (k == 0) {
                if (p->loop_file && got < n) {
                    if (::lseek(p->fd, 0, SEEK_SET) == 0) continue;
                }
                goto done;  // EOF / unseekable: end of stream
            } else {
                if (errno == EINTR) continue;
                if (errno == EAGAIN || errno == EWOULDBLOCK) {
                    // Non-blocking fd (e.g. a Python socket with a timeout
                    // set): wait for readability instead of treating the
                    // stall as end-of-stream.
                    struct pollfd pfd{p->fd, POLLIN, 0};
                    ::poll(&pfd, 1, 100);
                    if (p->stop.load(std::memory_order_relaxed)) goto done;
                    continue;
                }
                goto done;
            }
            if (p->stop.load(std::memory_order_relaxed)) goto done;
        }
        {
            std::unique_lock<std::mutex> lk(r->mu);
            if (r->count == r->capacity) {
                if (p->block_on_full) {
                    r->cv_push.wait(lk, [&] {
                        return r->count < r->capacity ||
                               p->stop.load(std::memory_order_relaxed);
                    });
                    if (p->stop.load(std::memory_order_relaxed)) break;
                } else {
                    // Drop-newest under overrun, like the reference feeder
                    // counts lost samples rather than stalling the radio.
                    r->dropped++;
                    continue;
                }
            }
            std::memcpy(r->arena + r->head * n, buf, n);
            r->head = (r->head + 1) % r->capacity;
            r->count++;
            p->blocks_read++;
        }
        r->cv_pop.notify_one();
    }
done:
    delete[] buf;
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->eof = true;
    }
    r->cv_pop.notify_all();
}

}  // namespace

extern "C" {

// -- ring ------------------------------------------------------------------

Ring* tsdr_ring_create(size_t block_bytes, size_t capacity) {
    if (block_bytes == 0 || capacity == 0) return nullptr;
    Ring* r = new Ring();
    r->arena = new uint8_t[block_bytes * capacity];
    r->block_bytes = block_bytes;
    r->capacity = capacity;
    return r;
}

void tsdr_ring_destroy(Ring* r) {
    if (!r) return;
    delete[] r->arena;
    delete r;
}

// 0 = stored, -1 = dropped (full), non-blocking.
int tsdr_ring_push(Ring* r, const uint8_t* src) {
    {
        std::lock_guard<std::mutex> lk(r->mu);
        if (r->count == r->capacity) {
            r->dropped++;
            return -1;
        }
        std::memcpy(r->arena + r->head * r->block_bytes, src, r->block_bytes);
        r->head = (r->head + 1) % r->capacity;
        r->count++;
    }
    r->cv_pop.notify_one();
    return 0;
}

// 1 = got block, 0 = timed out, -1 = EOF (and drained).
int tsdr_ring_pop(Ring* r, uint8_t* dst, int timeout_ms) {
    std::unique_lock<std::mutex> lk(r->mu);
    auto ready = [&] { return r->count > 0 || r->eof; };
    if (timeout_ms < 0) {
        r->cv_pop.wait(lk, ready);
    } else if (!r->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
        return 0;
    }
    if (r->count == 0) return -1;  // eof && drained
    std::memcpy(dst, r->arena + r->tail * r->block_bytes, r->block_bytes);
    r->tail = (r->tail + 1) % r->capacity;
    r->count--;
    lk.unlock();
    r->cv_push.notify_one();
    return 1;
}

size_t tsdr_ring_count(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->count;
}

uint64_t tsdr_ring_dropped(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->dropped;
}

void tsdr_ring_set_eof(Ring* r) {
    {
        std::lock_guard<std::mutex> lk(r->mu);
        r->eof = true;
    }
    r->cv_pop.notify_all();
}

int tsdr_ring_eof(Ring* r) {
    std::lock_guard<std::mutex> lk(r->mu);
    return r->eof ? 1 : 0;
}

// -- pump ------------------------------------------------------------------

// Spawn a reader thread pulling fixed blocks from `fd` into the ring.
// `loop_file`: rewind at EOF (file replay). `block_on_full`: apply
// backpressure instead of dropping.
Pump* tsdr_pump_start(Ring* r, int fd, int loop_file, int block_on_full) {
    Pump* p = new Pump();
    p->ring = r;
    p->fd = fd;
    p->loop_file = loop_file != 0;
    p->block_on_full = block_on_full != 0;
    p->thread = std::thread(pump_main, p);
    return p;
}

void tsdr_pump_stop(Pump* p) {
    if (!p) return;
    p->stop.store(true);
    p->ring->cv_push.notify_all();
    if (p->thread.joinable()) p->thread.join();
    delete p;
}

uint64_t tsdr_pump_blocks(Pump* p) { return p->blocks_read; }

// -- hot byte-path conversions ----------------------------------------------

// u8 interleaved I/Q -> planar centered/scaled f32 with fs/4 rotation
// (multiply sample k by j**(k+phase)).  Host-side twin of
// tpu_sdr.ops.fm.u8_to_f32 + rotate_fs4 (reference rotate_90 incl. its NEON
// path, simple_fm.rs:276-334); writing planar f32 lets jax.device_put skip
// a device-side conversion when the host path is preferred.
void tsdr_u8_iq_to_planar_f32(const uint8_t* iq, size_t n_pairs, int phase,
                              float scale, float* re, float* im) {
    const float off = 127.5f * scale;
    for (size_t k = 0; k < n_pairs; k++) {
        float i = static_cast<float>(iq[2 * k]) * scale - off;
        float q = static_cast<float>(iq[2 * k + 1]) * scale - off;
        switch ((k + static_cast<size_t>(phase)) & 3) {
            case 0: re[k] = i;  im[k] = q;  break;
            case 1: re[k] = -q; im[k] = i;  break;
            case 2: re[k] = -i; im[k] = -q; break;
            default: re[k] = q; im[k] = -i; break;
        }
    }
}

// fs/4 rotation as a pure byte map: multiply sample k by j**(k+phase)
// without leaving u8 space — negation of a centered sample (x = 2u - 255)
// is the byte complement 255 - u, so rotation only swaps/complements the
// I/Q bytes (the reference's own host-thread placement of this op,
// simple_fm.rs:276-334).  The per-period pattern is fixed once `phase` is known, so each case is
// a straight-line 8-byte map the compiler auto-vectorizes.
void tsdr_rotate_fs4_u8(const uint8_t* iq, uint8_t* out, size_t n_pairs,
                        int phase) {
    size_t k = 0;
#define TSDR_ROT0(s, d) { (d)[0] = (s)[0];       (d)[1] = (s)[1]; }
#define TSDR_ROT1(s, d) { (d)[0] = 255 - (s)[1]; (d)[1] = (s)[0]; }
#define TSDR_ROT2(s, d) { (d)[0] = 255 - (s)[0]; (d)[1] = 255 - (s)[1]; }
#define TSDR_ROT3(s, d) { (d)[0] = (s)[1];       (d)[1] = 255 - (s)[0]; }
#define TSDR_ROT_LOOP(A, B, C, D)                                         \
    for (; k + 4 <= n_pairs; k += 4) {                                    \
        const uint8_t* s = iq + 2 * k;                                    \
        uint8_t* d = out + 2 * k;                                         \
        TSDR_ROT##A(s, d) TSDR_ROT##B(s + 2, d + 2)                       \
        TSDR_ROT##C(s + 4, d + 4) TSDR_ROT##D(s + 6, d + 6)               \
    }
    switch (phase & 3) {
        case 0: TSDR_ROT_LOOP(0, 1, 2, 3) break;
        case 1: TSDR_ROT_LOOP(1, 2, 3, 0) break;
        case 2: TSDR_ROT_LOOP(2, 3, 0, 1) break;
        default: TSDR_ROT_LOOP(3, 0, 1, 2) break;
    }
    for (; k < n_pairs; k++) {  // ragged tail (blocks are 0 mod 4 anyway)
        const uint8_t* s = iq + 2 * k;
        uint8_t* d = out + 2 * k;
        switch ((k + static_cast<size_t>(phase)) & 3) {
            case 0: TSDR_ROT0(s, d) break;
            case 1: TSDR_ROT1(s, d) break;
            case 2: TSDR_ROT2(s, d) break;
            default: TSDR_ROT3(s, d) break;
        }
    }
#undef TSDR_ROT0
#undef TSDR_ROT1
#undef TSDR_ROT2
#undef TSDR_ROT3
#undef TSDR_ROT_LOOP
}

// f32 audio [-1,1] -> s16 PCM with clamping (ref output(),
// simple_fm.rs:430-438 emits s16-LE).
void tsdr_f32_to_s16(const float* x, size_t n, float scale, int16_t* out) {
    for (size_t k = 0; k < n; k++) {
        float v = x[k] * scale;
        if (v > 32767.f) v = 32767.f;
        if (v < -32768.f) v = -32768.f;
        out[k] = static_cast<int16_t>(v);
    }
}

// RTL2832U test-pattern continuity check: the chip emits an incrementing
// 8-bit counter in test mode (ref rtl_test.rs reads it; this version also
// verifies continuity, which the reference's rtl_test does not).  Returns
// the number of discontinuities; `*last` carries the counter across blocks
// (pass -1 on the first block).
uint64_t tsdr_count_pattern_breaks(const uint8_t* buf, size_t n, int* last) {
    uint64_t breaks = 0;
    int prev = *last;
    for (size_t k = 0; k < n; k++) {
        if (prev >= 0 && buf[k] != static_cast<uint8_t>(prev + 1)) breaks++;
        prev = buf[k];
    }
    *last = prev;
    return breaks;
}

// rtl_tcp 5-byte command framing: parse [cmd u8 | param u32 be] records
// from `buf`; returns the number of complete commands written to cmds/params
// (ref command_loop, rtl_tcp.rs:633-689).
size_t tsdr_parse_tcp_commands(const uint8_t* buf, size_t n, uint8_t* cmds,
                               uint32_t* params, size_t max_cmds) {
    size_t count = 0;
    for (size_t off = 0; off + 5 <= n && count < max_cmds; off += 5) {
        cmds[count] = buf[off];
        params[count] = (static_cast<uint32_t>(buf[off + 1]) << 24) |
                        (static_cast<uint32_t>(buf[off + 2]) << 16) |
                        (static_cast<uint32_t>(buf[off + 3]) << 8) |
                        static_cast<uint32_t>(buf[off + 4]);
        count++;
    }
    return count;
}

}  // extern "C"
