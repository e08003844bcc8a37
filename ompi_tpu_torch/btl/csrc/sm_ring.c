/* sm_ring — the SPSC byte ring of btl/sm, with real acquire/release
 * atomics.
 *
 * The port's own copy of the ring routines of the JAX package's native
 * core (its csrc/ompitpu_core.c: push, pop, readable); the reference's
 * analog is opal/class/opal_fifo.h's lock-free discipline. Plain C11,
 * no Python headers: built with the system C compiler at first use and
 * loaded with ctypes by ompi_tpu_torch/core/native.py.
 *
 * Layout contract with ompi_tpu_torch/btl/sm.py: the ring header is two
 * u64s (head, tail) at offset 0, data starts at byte 16; frames are a
 * 4-byte little-endian length and the payload, wrapping modulo the data
 * size. The writer owns head, the reader owns tail.
 */

#include <stdatomic.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define RING_HDR 16u

typedef struct {
    _Atomic uint64_t head; /* writer-owned */
    _Atomic uint64_t tail; /* reader-owned */
} ring_hdr_t;

static inline unsigned char *ring_data(void *base) {
    return (unsigned char *)base + RING_HDR;
}

static void copy_in(unsigned char *data, uint64_t size, uint64_t pos,
                    const unsigned char *src, uint64_t n) {
    uint64_t off = pos % size;
    if (off + n <= size) {
        memcpy(data + off, src, n);
    } else {
        uint64_t first = size - off;
        memcpy(data + off, src, first);
        memcpy(data, src + first, n - first);
    }
}

static void copy_out(const unsigned char *data, uint64_t size,
                     uint64_t pos, unsigned char *dst, uint64_t n) {
    uint64_t off = pos % size;
    if (off + n <= size) {
        memcpy(dst, data + off, n);
    } else {
        uint64_t first = size - off;
        memcpy(dst, data + off, first);
        memcpy(dst + first, data, n - first);
    }
}

/* Returns 1 on success, 0 if the ring lacks space. Release-publishes
 * head only after the payload bytes are globally visible. */
int otr_ring_push(void *base, uint64_t size, const unsigned char *frame,
                  uint32_t len) {
    ring_hdr_t *h = (ring_hdr_t *)base;
    uint64_t head = atomic_load_explicit(&h->head, memory_order_relaxed);
    uint64_t tail = atomic_load_explicit(&h->tail, memory_order_acquire);
    uint64_t need = 4ull + len;
    if (size - (head - tail) < need)
        return 0;
    unsigned char lenbuf[4] = {
        (unsigned char)(len & 0xff), (unsigned char)((len >> 8) & 0xff),
        (unsigned char)((len >> 16) & 0xff),
        (unsigned char)((len >> 24) & 0xff)};
    unsigned char *data = ring_data(base);
    copy_in(data, size, head, lenbuf, 4);
    copy_in(data, size, head + 4, frame, len);
    atomic_store_explicit(&h->head, head + need, memory_order_release);
    return 1;
}

/* Returns the payload length (>= 0) with the frame copied into out
 * (capacity cap), -1 if the ring is empty, -2 if cap is too small (the
 * frame stays in place). Acquire-loads head so the payload reads are
 * ordered after the publish. */
int64_t otr_ring_pop(void *base, uint64_t size, unsigned char *out,
                     uint64_t cap) {
    ring_hdr_t *h = (ring_hdr_t *)base;
    uint64_t tail = atomic_load_explicit(&h->tail, memory_order_relaxed);
    uint64_t head = atomic_load_explicit(&h->head, memory_order_acquire);
    if (head == tail)
        return -1;
    unsigned char lenbuf[4];
    const unsigned char *data = ring_data(base);
    copy_out(data, size, tail, lenbuf, 4);
    uint32_t len = (uint32_t)lenbuf[0] | ((uint32_t)lenbuf[1] << 8) |
                   ((uint32_t)lenbuf[2] << 16) |
                   ((uint32_t)lenbuf[3] << 24);
    if (len > cap)
        return -2;
    copy_out(data, size, tail + 4, out, len);
    atomic_store_explicit(&h->tail, tail + 4ull + len,
                          memory_order_release);
    return (int64_t)len;
}

/* Bytes currently queued (the reader's view). */
uint64_t otr_ring_readable(void *base) {
    ring_hdr_t *h = (ring_hdr_t *)base;
    uint64_t tail = atomic_load_explicit(&h->tail, memory_order_relaxed);
    uint64_t head = atomic_load_explicit(&h->head, memory_order_acquire);
    return head - tail;
}

int otr_abi_version(void) { return 1; }
