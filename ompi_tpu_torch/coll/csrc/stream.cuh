// stream.cuh — the streaming engine of ompi_tpu_torch's HBM-bound
// elementwise kernels. Included by coll/csrc/ring_kernels.cu (K1
// otc_rs_hop) and osc/csrc/rma_kernels.cu (K7 orm_apply, and apply_one for
// K8).
//
// The engine maps out[i] = C(a[i], b[i]) over a span of count elements,
// with C the Combine<T, OP> of combine.cuh (so NaN, -0/+0, bfloat16
// rounding and int32 wrap-around are K1's) or, for OP_REPLACE, b[i] (a put:
// a is never read). out may alias a (an in-place fold: each element is
// loaded and stored by one thread); a second output out2 (nullptr: none)
// receives the same values.
//
// What bounds it on the H100: HBM bytes (each input read once, each output
// written once; the combine is a handful of operations per 16 bytes). The
// design keeps enough bytes in flight to approach HBM's rate: a block owns
// one tile of STREAM_THREADS x STREAM_UNROLL 16-byte vectors of every input
// (16 KiB each), each thread issues all of its STREAM_UNROLL loads of every
// input before it combines any, loads and stores take the streaming cache
// hints (__ldcs / __stcs: the bytes are touched once), and the grid is the
// tile count. The first port's grid-stride loop (one vector of each input
// per thread per trip, a grid capped at 132 x 16 blocks) reached 84-86% of
// the bound on the device; this design 87-90%, as torch.add and copy_ do
// (PERF.md, scripts/stream_ab.py). A design that streamed tiles through
// shared memory with bulk asynchronous copies (cp.async.bulk, mbarriers, a
// persistent grid) was built and timed beside it, and lost to both
// (76-85%).
//
// A span cuts into a head of elements up to the first 16-byte boundary, a
// body of 16-byte vectors and a tail of elements, all in one launch. When
// the pointers do not share one offset modulo 16 (a clamped window start
// against an aligned payload) there is no body: the element loop takes the
// whole span.

#pragma once

#include "combine.cuh"

// put and replace: the payload overwrites the current value
#define OP_REPLACE 4

template <typename T, int OP>
__device__ __forceinline__ T apply_one(T cur, T payload) {
    if constexpr (OP == OP_REPLACE) {
        return payload;
    } else {
        return Combine<T, OP>::f(cur, payload);
    }
}

template <typename T, int OP>
__device__ __forceinline__ Vec<T> apply_vec(const Vec<T>& cur,
                                            const Vec<T>& payload) {
    Vec<T> r;
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(T); ++e)
        r.v[e] = apply_one<T, OP>(cur.v[e], payload.v[e]);
    return r;
}

#define STREAM_THREADS 256
// 16-byte vectors of each input a thread loads: 2, 4 and 8 take the same
// time from 1 MiB up; 8 loses at 1 MiB and 256 KiB (too few blocks)
#define STREAM_UNROLL 4
// a body of fewer bytes takes one vector per thread: its tiles are then
// 4 KiB, so a 256 KiB chunk (the 1 MiB Allreduce's) spreads over 256
// blocks, not 64, and takes 0.0023 ms on the device instead of 0.0026
// (scripts/stream_ab.py, NVIDIA H100 80GB HBM3, 700 W); from 1 MiB up the
// two take the same time
#define STREAM_SMALL (1 << 20)

struct StreamSpan {
    const void* a;  // the current value / carry (unread by OP_REPLACE)
    const void* b;  // the payload / own chunk
    void* out;      // may alias a
    void* out2;     // a second output, or nullptr
    int64_t count;  // elements
    int64_t head;   // elements before the body (count: no body)
    int64_t nvec;   // 16-byte vectors in the body
};

template <typename T, int OP>
static StreamSpan stream_span(const void* a, const void* b, void* out,
                              void* out2, int64_t count) {
    const uintptr_t m = (uintptr_t)out & 15;
    const bool one = ((uintptr_t)b & 15) == m &&
                     (OP == OP_REPLACE || ((uintptr_t)a & 15) == m) &&
                     (out2 == nullptr || ((uintptr_t)out2 & 15) == m);
    StreamSpan s = {a, b, out, out2, count, count, 0};
    if (one && m % sizeof(T) == 0) {
        const int64_t head = (int64_t)((16 - m) & 15) / (int64_t)sizeof(T);
        s.head = head < count ? head : count;
        s.nvec = (count - s.head) * (int64_t)sizeof(T) / 16;
    }
    return s;
}

// the head and the tail, one element per thread, grid-stride
template <typename T, int OP>
__device__ __forceinline__ void stream_elems(const StreamSpan& s) {
    const T* a = static_cast<const T*>(s.a);
    const T* b = static_cast<const T*>(s.b);
    T* out = static_cast<T*>(s.out);
    T* out2 = static_cast<T*>(s.out2);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    auto one = [&](int64_t i) {
        const T r = apply_one<T, OP>(OP == OP_REPLACE ? b[i] : a[i], b[i]);
        out[i] = r;
        if (out2 != nullptr) out2[i] = r;
    };
    for (int64_t i = tid; i < s.head; i += stride) one(i);
    const int64_t tail = s.head + s.nvec * (16 / (int64_t)sizeof(T));
    for (int64_t i = tail + tid; i < s.count; i += stride) one(i);
}

template <typename T>
__device__ __forceinline__ Vec<T> ld_stream(const Vec<T>* p) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    Vec<T> r;
    *reinterpret_cast<uint4*>(&r) = u;
    return r;
}

template <typename T>
__device__ __forceinline__ void st_stream(Vec<T>* p, const Vec<T>& v) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
}

// per: the vectors each thread takes in this launch, 1..STREAM_UNROLL
template <typename T, int OP>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_kernel(const StreamSpan s, int per) {
    constexpr int U = STREAM_UNROLL;
    stream_elems<T, OP>(s);
    const Vec<T>* a =
        reinterpret_cast<const Vec<T>*>(static_cast<const T*>(s.a) + s.head);
    const Vec<T>* b =
        reinterpret_cast<const Vec<T>*>(static_cast<const T*>(s.b) + s.head);
    Vec<T>* out = reinterpret_cast<Vec<T>*>(static_cast<T*>(s.out) + s.head);
    Vec<T>* out2 = s.out2 == nullptr ? nullptr : reinterpret_cast<Vec<T>*>(
        static_cast<T*>(s.out2) + s.head);
    const int64_t i0 =
        (int64_t)blockIdx.x * STREAM_THREADS * per + threadIdx.x;
    Vec<T> x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t i = i0 + (int64_t)u * STREAM_THREADS;
        if (u < per && i < s.nvec) {
            y[u] = ld_stream(b + i);
            if (OP != OP_REPLACE) x[u] = ld_stream(a + i);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t i = i0 + (int64_t)u * STREAM_THREADS;
        if (u < per && i < s.nvec) {
            const Vec<T> r = apply_vec<T, OP>(OP == OP_REPLACE ? y[u] : x[u],
                                              y[u]);
            st_stream(out + i, r);
            if (out2 != nullptr) st_stream(out2 + i, r);
        }
    }
}

// out = C(a, b) (and out2) over count elements, launched on st; returns a
// cudaError_t as int
template <typename T, int OP>
static int stream_launch(const void* a, const void* b, void* out, void* out2,
                         int64_t count, cudaStream_t st) {
    const StreamSpan s = stream_span<T, OP>(a, b, out, out2, count);
    const int per = s.nvec * 16 < STREAM_SMALL ? 1 : STREAM_UNROLL;
    const int64_t tile = (int64_t)STREAM_THREADS * per;
    const int64_t grid = s.nvec ? (s.nvec + tile - 1) / tile : grid_for(count);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
    stream_kernel<T, OP><<<(int)grid, STREAM_THREADS, 0, st>>>(s, per);
    return (int)cudaGetLastError();
}
