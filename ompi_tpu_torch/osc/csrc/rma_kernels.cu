// rma_kernels.cu — the one-sided (RMA) kernels of ompi_tpu_torch.osc,
// written by hand for Hopper (sm_90a), with a plain C interface that
// ompi_tpu_torch/osc/cuda_kernels.py loads with ctypes.
//
// Replaces (JAX package, ompi_tpu/osc/pallas_kernels.py):
//   orm_apply          K7  _apply_fn (via apply, stride 1):
//                          window[d:d+k] = C(window[d:d+k], payload), d the
//                          reference's start (start()): a disp in [-size, 0)
//                          counts from the end (Pallas indexing), then it is
//                          clamped into [0, size-k] as lax.dynamic_slice
//                          clamps it. The TPU kernel writes a whole new
//                          window per call (its outputs are fresh arrays);
//                          this one updates the k elements in place.
//   orm_apply_strided_batch  K8  _apply_strided_fn, grouped: one launch over
//                          a table of descriptors {payload, d, k, s, op},
//                          each window[d+i*s] = C(window[d+i*s], payload[i])
//                          for i < k. The host has already dropped what falls
//                          outside the window (the TPU kernel's masked select)
//                          and clamped contiguous starts (s == 1, K7's rule),
//                          so every index a descriptor names lands. The
//                          descriptors of one launch touch pairwise disjoint
//                          elements (the host cuts its list into such runs, in
//                          order), so their blocks need no order among them.
//   orm_read_batch     K9  _read_fn, grouped: one launch over a table
//                          {d, s, k, out offset} reading one window into one
//                          output: window[d:d+k] from the clamped start
//                          (s == 1), or window[d+i*s] (s != 1) with jnp.take's
//                          fill mode: an index in [-size, 0) counts from the
//                          end, one outside [-size, size) reads the fill value
//                          (NaN for float32 and bfloat16, INT_MIN for int32).
//   orm_permute_recv_batch  K10 dma_permute's receive side, grouped: one
//                          launch over a table of spans {src or null, dst,
//                          count}, each copying a block a source rank staged
//                          in its own arena region, read through the peer
//                          pointer, into its landing tensor; zeros when there
//                          is no source (the -1 sentinel). A pull, as K2
//                          pulls; the handshake with the partners is the
//                          host's (coll/cuda.py Arena.exchange).
//                          orm_permute_recv is its batch of one.
//
// C is C(current, payload): REPLACE (put and replace) returns the payload,
// SUM / PROD / MIN / MAX are the Combine of combine.cuh with the operand
// order of _COMBINE (pallas_kernels.py:50-57), so NaN, -0/+0, bfloat16
// rounding and int32 wrapping follow jnp exactly as K1 does.
//
// What bounds them on the H100. K7, K10 and a contiguous K9 are bound by
// HBM bytes (K7 reads the payload and writes the slice, 2k elements for
// REPLACE and 3k with the read of the slice for a fold; K9 and K10 read and
// write k each). K7 runs on the streaming engine of coll/csrc/stream.cuh,
// the window slice as the first input and the output (a put never reads
// it): one block per 16 KiB tile, each thread issuing its four 16-byte
// loads before it stores, streaming cache hints, the grid the tile count.
// On the halo tile's 256 MiB put the first port's grid-stride loop (one
// vector per thread per trip, 132 x 16 blocks at most) reached 84% of the
// bound on the device, the engine 88%, as copy_ does (PERF.md section 6,
// scripts/stream_ab.py). Where the window slice and the payload do not share one
// offset modulo 16 (a clamped start) the engine's element loop takes the
// span. K10 is a copy bound the same way (k elements read, k written; k
// written for zeros), and runs the same engine: one launch over a table
// of spans, each with the engine's head, body and tail (stream_span, on
// the host), one block per tile, a block finding its span from the
// per-span first tiles by binary search; a span of 1 MiB or more takes
// four vectors a thread, a smaller one one (STREAM_SMALL). The first
// port's grid-stride loop lost to copy_ on the 256 MiB block, and the
// one-sided fence launched it once per source rank and reader (16 times
// on the 4-rank embedding lookup): now once per reader and exchange. A
// strided K8 or K9 touches one element every s, a 32-byte sector each. But
// at the paths' shapes (an 8192-element halo column, one 128-float
// embedding row) a call moves kilobytes: its bound is well under a
// microsecond, and what the call costs is the launch and the host's
// wrapper around it, once per descriptor. The grouped design attacks that: the one-sided fence hands
// the kernels every descriptor of an exchange (a run of coloured rounds,
// coll/cuda.py Arena.exchange) at once, and one launch serves the whole
// table. The table travels by value in the kernel's parameter block
// (__grid_constant__, up to ORM_TABLE_MAX descriptors of 32 bytes within
// CUDA 12.1's 32,764 bytes), so no copy precedes the launch (a table
// copied with cudaMemcpyAsync from pinned memory timed slower at every
// size, scripts/rma_table_ab.py); the kernel is instantiated for four
// capacities, so a batch of one passes 40 bytes of table, not 32 KiB. A
// tile scheduler spreads each descriptor over tiles (4096 bytes of a
// contiguous one: one 16-byte vector per thread of a 256-thread block;
// 256 elements of a strided one: one sector per thread): the host numbers
// each descriptor's first tile, and a block finds the descriptor of its
// tile by binary search over the table, so the 8192-element column (32
// tiles) and a 128-element row (one tile) both spread over the SMs.
// Contiguous descriptors whose payload and window pointers are 16-byte
// aligned take 16-byte vectors; the rest one element per thread. The
// payload pointer may be a peer's arena region (read through its IPC
// mapping), which fuses K10's pull into the apply.
//
// Every entry point returns a cudaError_t as int: 0 on success, else the
// error of the call or of the launch (cudaGetLastError()).

#include "../../coll/csrc/stream.cuh"

// a batch's tile: one 16-byte vector per thread of a contiguous
// descriptor, one element per thread of a strided one (each a sector of
// its own: more blocks in flight hide more of their latency)
#define ORM_TILE_BYTES (OTC_THREADS * 16)

template <typename T>
__host__ __device__ __forceinline__ int64_t tile_elems(int64_t s) {
    return s == 1 ? ORM_TILE_BYTES / (int64_t)sizeof(T) : OTC_THREADS;
}
// the largest table one launch takes: 8 + 32 * 1016 bytes of table plus
// the other parameters stay within the 32,764-byte parameter block
#define ORM_TABLE_MAX 1016

// one descriptor of a K8 batch: window[d + i*s] = C(window[d + i*s],
// pay[i]) for i < k, every index inside the window
struct ApplyDesc {
    const void* pay;  // payload: own memory or a peer's arena region
    int64_t d;        // first window index
    int32_t k;        // elements
    int32_t s;        // stride, >= 1
    int32_t op;       // OP_SUM .. OP_REPLACE
    int32_t tile0;    // the descriptor's first tile (set by the launcher)
};

// one descriptor of a K9 batch: out[o + i] = window[d + i*s] for i < k
struct ReadDesc {
    int64_t d;    // first index (the clamped start when s == 1)
    int64_t s;    // stride (1: contiguous, else jnp.take's fill mode)
    int64_t out;  // element offset in the output
    int32_t k;    // elements
    int32_t tile0;
};

static_assert(sizeof(ApplyDesc) == 32, "ApplyDesc is 32 bytes");
static_assert(sizeof(ReadDesc) == 32, "ReadDesc is 32 bytes");

template <typename D, int CAP> struct Table {
    int32_t n;      // descriptors
    int32_t tiles;  // tiles over all of them
    D desc[CAP];
};

static_assert(sizeof(Table<ReadDesc, ORM_TABLE_MAX>) + 32 <= 32764,
              "a full table and the other parameters fit one launch");

template <typename T> struct Bits;
template <> struct Bits<float> {
    static __device__ __forceinline__ float of(uint32_t b) {
        return __uint_as_float(b);
    }
};
template <> struct Bits<__nv_bfloat16> {
    static __device__ __forceinline__ __nv_bfloat16 of(uint32_t b) {
        return __ushort_as_bfloat16((unsigned short)b);
    }
};
template <> struct Bits<int32_t> {
    static __device__ __forceinline__ int32_t of(uint32_t b) {
        return (int32_t)b;
    }
};

static inline int64_t esize(int dtype) { return dtype == DT_BF16 ? 2 : 4; }

__device__ __forceinline__ bool aligned16_dev(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// the start of the reference's k-slice at d (requires 0 < k <= size)
static inline int64_t start(int64_t size, int64_t k, int64_t d) {
    if (d < 0) d += size;
    if (d < 0) d = 0;
    if (d > size - k) d = size - k;
    return d;
}

// K7, win[i] = C(win[i], pay[i]) for i < k (win already at the clamped
// start), is stream.cuh's stream_launch<T, OP>(win, pay, win, nullptr, k,
// stream): the fold's output aliases its first input.

// ---------------------------------------------------------------------------
// the tile scheduler: the descriptor whose tiles hold tile t (the last one
// whose first tile is <= t; a k == 0 descriptor owns no tile)

template <typename D>
__device__ __forceinline__ int find_desc(const D* descs, int n, int t) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (descs[mid].tile0 <= t) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// ---------------------------------------------------------------------------
// K8, grouped: one tile [e0, e1) of one descriptor

template <typename T, int OP>
__device__ __forceinline__ void apply_part(T* __restrict__ win,
                                           const ApplyDesc& D, int64_t e0,
                                           int64_t e1) {
    constexpr int V = 16 / sizeof(T);
    const T* __restrict__ pay = static_cast<const T*>(D.pay);
    if (D.s == 1) {
        T* w = win + D.d;
        if (aligned16_dev(w) && aligned16_dev(pay)) {
            int64_t e = e0 + (int64_t)threadIdx.x * V;
            if (e + V <= e1) {
                const Vec<T> p = *reinterpret_cast<const Vec<T>*>(pay + e);
                Vec<T>* wp = reinterpret_cast<Vec<T>*>(w + e);
                if (OP == OP_REPLACE) {
                    *wp = p;
                } else {
                    Vec<T> c = *wp;
#pragma unroll
                    for (int j = 0; j < V; ++j)
                        c.v[j] = apply_one<T, OP>(c.v[j], p.v[j]);
                    *wp = c;
                }
            } else {
                for (; e < e1; ++e) w[e] = apply_one<T, OP>(w[e], pay[e]);
            }
            return;
        }
    }
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
        const int64_t j = D.d + e * D.s;
        win[j] = apply_one<T, OP>(win[j], pay[e]);
    }
}

template <typename T>
__device__ __forceinline__ void apply_tile(T* __restrict__ win,
                                           const ApplyDesc* descs, int n,
                                           int t) {
    const ApplyDesc D = descs[find_desc(descs, n, t)];
    const int64_t te = tile_elems<T>(D.s);
    const int64_t e0 = (int64_t)(t - D.tile0) * te;
    const int64_t e1 = e0 + te < D.k ? e0 + te : (int64_t)D.k;
    switch (D.op) {
    case OP_SUM: apply_part<T, OP_SUM>(win, D, e0, e1); break;
    case OP_PROD: apply_part<T, OP_PROD>(win, D, e0, e1); break;
    case OP_MIN: apply_part<T, OP_MIN>(win, D, e0, e1); break;
    case OP_MAX: apply_part<T, OP_MAX>(win, D, e0, e1); break;
    default: apply_part<T, OP_REPLACE>(win, D, e0, e1); break;
    }
}

template <typename T, int CAP>
__global__ void __launch_bounds__(OTC_THREADS)
apply_batch_kernel(T* __restrict__ win,
                   const __grid_constant__ Table<ApplyDesc, CAP> tab) {
    for (int t = blockIdx.x; t < tab.tiles; t += gridDim.x)
        apply_tile<T>(win, tab.desc, tab.n, t);
}

// ---------------------------------------------------------------------------
// K9, grouped: one tile [e0, e1) of one descriptor

template <typename T>
__device__ __forceinline__ void read_tile(const T* __restrict__ win,
                                          int64_t size, T* __restrict__ out,
                                          uint32_t fill,
                                          const ReadDesc* descs, int n,
                                          int t) {
    constexpr int V = 16 / sizeof(T);
    const ReadDesc D = descs[find_desc(descs, n, t)];
    const int64_t te = tile_elems<T>(D.s);
    const int64_t e0 = (int64_t)(t - D.tile0) * te;
    const int64_t e1 = e0 + te < D.k ? e0 + te : (int64_t)D.k;
    T* o = out + D.out;
    if (D.s == 1) {
        const T* w = win + D.d;
        if (aligned16_dev(w) && aligned16_dev(o)) {
            int64_t e = e0 + (int64_t)threadIdx.x * V;
            if (e + V <= e1) {
                *reinterpret_cast<Vec<T>*>(o + e) =
                    *reinterpret_cast<const Vec<T>*>(w + e);
            } else {
                for (; e < e1; ++e) o[e] = w[e];
            }
        } else {
            for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x)
                o[e] = w[e];
        }
        return;
    }
    for (int64_t e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
        int64_t j = D.d + e * D.s;
        if (j < 0) j += size;
        o[e] = (j >= 0 && j < size) ? win[j] : Bits<T>::of(fill);
    }
}

template <typename T, int CAP>
__global__ void __launch_bounds__(OTC_THREADS)
read_batch_kernel(const T* __restrict__ win, int64_t size,
                  T* __restrict__ out, uint32_t fill,
                  const __grid_constant__ Table<ReadDesc, CAP> tab) {
    for (int t = blockIdx.x; t < tab.tiles; t += gridDim.x)
        read_tile<T>(win, size, out, fill, tab.desc, tab.n, t);
}

// ---------------------------------------------------------------------------
// the batch launchers: copy the host's table into the parameter block of
// the smallest instance that holds it, numbering each descriptor's tiles

template <typename T, typename D, int CAP>
static int fill_table(Table<D, CAP>& tab, const D* descs, int n) {
    int64_t tiles = 0;
    for (int i = 0; i < n; ++i) {
        if (descs[i].k < 0) return (int)cudaErrorInvalidValue;
        const int64_t te = tile_elems<T>(descs[i].s);
        tab.desc[i] = descs[i];
        tab.desc[i].tile0 = (int32_t)tiles;
        tiles += (descs[i].k + te - 1) / te;
        if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
    }
    tab.n = n;
    tab.tiles = (int32_t)tiles;
    return 0;
}

template <typename T, int CAP>
static int launch_apply_batch(void* win, const ApplyDesc* descs, int n,
                              cudaStream_t st) {
    Table<ApplyDesc, CAP> tab;
    int rc = fill_table<T>(tab, descs, n);
    if (rc != 0 || tab.tiles == 0) return rc;
    apply_batch_kernel<T, CAP><<<grid_for((int64_t)tab.tiles * OTC_THREADS),
                                 OTC_THREADS, 0, st>>>((T*)win, tab);
    return (int)cudaGetLastError();
}

template <typename T>
static int apply_batch(void* win, const ApplyDesc* descs, int n,
                       cudaStream_t st) {
    if (n <= 1) return launch_apply_batch<T, 1>(win, descs, n, st);
    if (n <= 16) return launch_apply_batch<T, 16>(win, descs, n, st);
    if (n <= 128) return launch_apply_batch<T, 128>(win, descs, n, st);
    return launch_apply_batch<T, ORM_TABLE_MAX>(win, descs, n, st);
}

template <typename T, int CAP>
static int launch_read_batch(const void* win, int64_t size, void* out,
                             uint32_t fill, const ReadDesc* descs, int n,
                             cudaStream_t st) {
    Table<ReadDesc, CAP> tab;
    int rc = fill_table<T>(tab, descs, n);
    if (rc != 0 || tab.tiles == 0) return rc;
    read_batch_kernel<T, CAP><<<grid_for((int64_t)tab.tiles * OTC_THREADS),
                                OTC_THREADS, 0, st>>>(
        (const T*)win, size, (T*)out, fill, tab);
    return (int)cudaGetLastError();
}

template <typename T>
static int read_batch(const void* win, int64_t size, void* out,
                      uint32_t fill, const ReadDesc* descs, int n,
                      cudaStream_t st) {
    if (n <= 1)
        return launch_read_batch<T, 1>(win, size, out, fill, descs, n, st);
    if (n <= 16)
        return launch_read_batch<T, 16>(win, size, out, fill, descs, n, st);
    if (n <= 128)
        return launch_read_batch<T, 128>(win, size, out, fill, descs, n, st);
    return launch_read_batch<T, ORM_TABLE_MAX>(win, size, out, fill, descs,
                                               n, st);
}

// ---------------------------------------------------------------------------
// K10, grouped: one launch copies a table of spans {src or null, dst,
// count}, each on the streaming engine's OP_REPLACE mode (which never reads
// its first input; a null src stores zeros). The copy moves bits, so T is
// the unsigned integer of the element's size: NaN payloads, signalling
// ones included, and -0 land unchanged.

// the largest table one launch takes (at least OTC_MAX_PEERS, a source per
// rank of a communicator); the wrapper cuts a longer list
#define ORM_COPY_MAX 64

// one span as the host hands it over
struct CopyDesc {
    const void* src;  // nullptr: zeros (the -1 sentinel)
    void* dst;
    int64_t count;    // elements
};

// one span of a launch: the engine's cut (stream_span) and its tiles
struct CopySpan {
    const void* src;
    void* dst;
    int64_t count;
    int64_t head;   // elements before the body (count: no body)
    int64_t nvec;   // 16-byte vectors in the body
    int32_t per;    // vectors (elements, with no body) a thread takes
    int32_t tile0;  // the span's first tile
};

static_assert(sizeof(CopyDesc) == 24, "CopyDesc is 24 bytes");
static_assert(sizeof(CopySpan) == 48, "CopySpan is 48 bytes");

template <int CAP> struct CopyTable {
    int32_t n;      // spans
    int32_t tiles;  // tiles over all of them
    CopySpan span[CAP];
};

// one block per tile: the block finds its span, then copies one tile of
// its body (the span's first tile also its head and tail) or, for a span
// with no body, one tile of its elements
template <typename T, int CAP>
__global__ void __launch_bounds__(STREAM_THREADS)
copy_batch_kernel(const __grid_constant__ CopyTable<CAP> tab) {
    const int t = blockIdx.x;
    const CopySpan& c = tab.span[find_desc(tab.span, tab.n, t)];
    const StreamSpan s = {nullptr, c.src, c.dst, nullptr, c.count, c.head,
                          c.nvec};
    const int64_t lt = t - c.tile0;
    if (c.nvec == 0) {
        stream_elem_tile<T, OP_REPLACE>(s, lt, c.per);
        return;
    }
    if (lt == 0) stream_edges<T, OP_REPLACE>(s);
    stream_tile<T, OP_REPLACE>(s, lt, c.per);
}

template <typename T, int CAP>
static int launch_copy_batch(const CopyDesc* descs, int n, cudaStream_t st) {
    CopyTable<CAP> tab;
    int64_t tiles = 0;
    int m = 0;
    for (int i = 0; i < n; ++i) {
        const CopyDesc& d = descs[i];
        if (d.count < 0) return (int)cudaErrorInvalidValue;
        if (d.count == 0) continue;  // owns no tile
        // a null src reads nothing: only dst's offset decides the body
        const StreamSpan s = stream_span<T, OP_REPLACE>(
            nullptr, d.src != nullptr ? d.src : d.dst, d.dst, nullptr,
            d.count);
        const int per = stream_per<T>(s);
        tab.span[m] = {d.src, d.dst, d.count, s.head, s.nvec, per,
                       (int32_t)tiles};
        tiles += stream_tiles(s, per);
        if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
        ++m;
    }
    if (m == 0) return 0;
    tab.n = m;
    tab.tiles = (int32_t)tiles;
    copy_batch_kernel<T, CAP><<<(int)tiles, STREAM_THREADS, 0, st>>>(tab);
    return (int)cudaGetLastError();
}

template <typename T>
static int copy_batch(const CopyDesc* descs, int n, cudaStream_t st) {
    if (n <= 1) return launch_copy_batch<T, 1>(descs, n, st);
    if (n <= 16) return launch_copy_batch<T, 16>(descs, n, st);
    return launch_copy_batch<T, ORM_COPY_MAX>(descs, n, st);
}

static int copy_batch_dtype(int dtype, const CopyDesc* descs, int n,
                            cudaStream_t st) {
    switch (dtype) {
    case DT_F32:
    case DT_I32: return copy_batch<uint32_t>(descs, n, st);
    case DT_BF16: return copy_batch<uint16_t>(descs, n, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

// dispatch a templated launcher over (dtype, op incl. REPLACE)
#define ORM_CASES(DT, T, LAUNCH, ...)                                      \
    case DT * 8 + OP_SUM: LAUNCH<T, OP_SUM>(__VA_ARGS__); break;           \
    case DT * 8 + OP_PROD: LAUNCH<T, OP_PROD>(__VA_ARGS__); break;         \
    case DT * 8 + OP_MIN: LAUNCH<T, OP_MIN>(__VA_ARGS__); break;           \
    case DT * 8 + OP_MAX: LAUNCH<T, OP_MAX>(__VA_ARGS__); break;           \
    case DT * 8 + OP_REPLACE: LAUNCH<T, OP_REPLACE>(__VA_ARGS__); break;

#define ORM_DISPATCH(LAUNCH, dtype, op, ...)                               \
    do {                                                                   \
        if ((op) < 0 || (op) > OP_REPLACE) return (int)cudaErrorInvalidValue; \
        switch ((dtype) * 8 + (op)) {                                      \
        ORM_CASES(DT_F32, float, LAUNCH, __VA_ARGS__)                      \
        ORM_CASES(DT_BF16, __nv_bfloat16, LAUNCH, __VA_ARGS__)             \
        ORM_CASES(DT_I32, int32_t, LAUNCH, __VA_ARGS__)                    \
        default: return (int)cudaErrorInvalidValue;                        \
        }                                                                  \
    } while (0)

extern "C" {

int orm_apply(int dtype, int op, void* win, int64_t size, const void* pay,
              int64_t k, int64_t d, void* stream) {
    if (k <= 0) return 0;
    if (k > size) return (int)cudaErrorInvalidValue;
    void* at = (char*)win + start(size, k, d) * esize(dtype);
    int rc = 0;
    ORM_DISPATCH(rc = stream_launch, dtype, op, at, pay, at, nullptr, k,
                 (cudaStream_t)stream);
    return rc;
}

// descs: n host descriptors (their tile0 is ignored); 0 < n <= ORM_TABLE_MAX
int orm_apply_strided_batch(int dtype, void* win, const void* descs, int n,
                            void* stream) {
    if (n <= 0 || n > ORM_TABLE_MAX) return (int)cudaErrorInvalidValue;
    const ApplyDesc* t = (const ApplyDesc*)descs;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
    case DT_F32: return apply_batch<float>(win, t, n, st);
    case DT_BF16: return apply_batch<__nv_bfloat16>(win, t, n, st);
    case DT_I32: return apply_batch<int32_t>(win, t, n, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

int orm_read_batch(int dtype, const void* win, int64_t size, void* out,
                   uint32_t fill, const void* descs, int n, void* stream) {
    if (n <= 0 || n > ORM_TABLE_MAX) return (int)cudaErrorInvalidValue;
    const ReadDesc* t = (const ReadDesc*)descs;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
    case DT_F32: return read_batch<float>(win, size, out, fill, t, n, st);
    case DT_BF16:
        return read_batch<__nv_bfloat16>(win, size, out, fill, t, n, st);
    case DT_I32: return read_batch<int32_t>(win, size, out, fill, t, n, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

// K10, the batch of one: count elements of dtype from src (or zeros) to dst
int orm_permute_recv(int dtype, const void* src, void* dst, int64_t count,
                     void* stream) {
    const CopyDesc d = {src, dst, count};
    return copy_batch_dtype(dtype, &d, 1, (cudaStream_t)stream);
}

// K10, grouped: descs holds n CopyDesc; 0 < n <= ORM_COPY_MAX
int orm_permute_recv_batch(int dtype, const void* descs, int n,
                           void* stream) {
    if (n <= 0 || n > ORM_COPY_MAX) return (int)cudaErrorInvalidValue;
    return copy_batch_dtype(dtype, (const CopyDesc*)descs, n,
                            (cudaStream_t)stream);
}

int orm_copy_max(void) { return ORM_COPY_MAX; }

int orm_table_max(void) { return ORM_TABLE_MAX; }

const char* orm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
