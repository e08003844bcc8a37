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
//   orm_apply_strided  K8  _apply_strided_fn: window[d+i*s] =
//                          C(window[d+i*s], payload[i]) for i < k where
//                          0 <= d+i*s < size; the rest are dropped (the TPU
//                          kernel's masked select over the whole window).
//                          One thread per payload element; s <= 0 hits
//                          nothing, as in the reference.
//   orm_read           K9  _read_fn: window[d:d+k] from the same start (s == 1),
//                          or window[d+i*s] (s != 1) with jnp.take's fill
//                          mode: an index in [-size, 0) counts from the end,
//                          one outside [-size, size) reads the fill value
//                          (NaN for float32 and bfloat16, INT_MIN for
//                          int32). It writes straight into the caller's
//                          output, so a get's payload lands in the target's
//                          arena slot with no extra copy.
//   orm_permute_recv   K10 dma_permute's receive side: copy the k-element
//                          payload a round's source rank staged in its own
//                          arena slot, read through the peer pointer, into
//                          the landing tensor; zeros when the round gives
//                          this rank no source (the -1 sentinel). A pull, as
//                          K2 pulls; the handshake with the round's partners
//                          is the host's (coll/cuda.py Arena.round).
//
// C is C(current, payload): REPLACE (put and replace) returns the payload,
// SUM / PROD / MIN / MAX are the Combine of combine.cuh with the operand
// order of _COMBINE (pallas_kernels.py:50-57), so NaN, -0/+0, bfloat16
// rounding and int32 wrapping follow jnp exactly as K1 does.
//
// What bounds them on the H100: HBM bytes. K7 reads the payload and writes
// the slice (2k elements for REPLACE, 3k with the read of the slice for a
// fold); K9 and K10 read and write k elements each. K7, K9 (contiguous) and
// K10 take the grid-stride loop of 16-byte loads and stores where both
// pointers are 16-byte aligned, else one element at a time. K8 and K9
// (strided) touch one element every s: each costs a 32-byte sector read
// (and, for K8, written) of the window, so their bound counts sectors.
// Nothing here is tiled, asynchronous or fused with the round transport:
// those are later work.
//
// Every entry point returns a cudaError_t as int: 0 on success, else the
// error of the call or of the launch (cudaGetLastError()).

#include "../../coll/csrc/combine.cuh"

// put and replace: the payload overwrites the window's elements
#define OP_REPLACE 4

template <typename T, int OP>
__device__ __forceinline__ T apply_one(T cur, T payload) {
    if constexpr (OP == OP_REPLACE) {
        return payload;
    } else {
        return Combine<T, OP>::f(cur, payload);
    }
}

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

// the start of the reference's k-slice at d (requires 0 < k <= size)
static inline int64_t start(int64_t size, int64_t k, int64_t d) {
    if (d < 0) d += size;
    if (d < 0) d = 0;
    if (d > size - k) d = size - k;
    return d;
}

// ---------------------------------------------------------------------------
// K7: win[i] = C(win[i], pay[i]) for i < k (win already at the clamped start)

template <typename T, int OP>
__global__ void apply_kernel(T* __restrict__ win, const T* __restrict__ pay,
                             int64_t k, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    Vec<T>* wv = reinterpret_cast<Vec<T>*>(win);
    const Vec<T>* pv = reinterpret_cast<const Vec<T>*>(pay);
    for (int64_t i = tid; i < nvec; i += stride) {
        Vec<T> p = pv[i];
        if (OP == OP_REPLACE) {
            wv[i] = p;
        } else {
            Vec<T> c = wv[i];
#pragma unroll
            for (int e = 0; e < V; ++e)
                c.v[e] = apply_one<T, OP>(c.v[e], p.v[e]);
            wv[i] = c;
        }
    }
    for (int64_t i = nvec * V + tid; i < k; i += stride)
        win[i] = apply_one<T, OP>(win[i], pay[i]);
}

template <typename T, int OP>
static void launch_apply(void* win, const void* pay, int64_t k,
                         cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = aligned16(win) && aligned16(pay);
    int64_t nvec = vec ? k / V : 0;
    apply_kernel<T, OP><<<grid_for(vec ? nvec : k), OTC_THREADS, 0, s>>>(
        (T*)win, (const T*)pay, k, nvec);
}

// ---------------------------------------------------------------------------
// K8: win[d+i*s] = C(win[d+i*s], pay[i]) where 0 <= d+i*s < size (s >= 1)

template <typename T, int OP>
__global__ void apply_strided_kernel(T* __restrict__ win, int64_t size,
                                     const T* __restrict__ pay, int64_t k,
                                     int64_t d, int64_t s) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k;
         i += stride) {
        int64_t j = d + i * s;
        if (j >= 0 && j < size) win[j] = apply_one<T, OP>(win[j], pay[i]);
    }
}

template <typename T, int OP>
static void launch_apply_strided(void* win, int64_t size, const void* pay,
                                 int64_t k, int64_t d, int64_t s,
                                 cudaStream_t st) {
    apply_strided_kernel<T, OP><<<grid_for(k), OTC_THREADS, 0, st>>>(
        (T*)win, size, (const T*)pay, k, d, s);
}

// ---------------------------------------------------------------------------
// K9 (strided): out[i] = win[d+i*s], counting [-size, 0) from the end and
// reading `fill` outside [-size, size)

template <typename T>
__global__ void read_strided_kernel(const T* __restrict__ win, int64_t size,
                                    T* __restrict__ out, int64_t k,
                                    int64_t d, int64_t s, uint32_t fill) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k;
         i += stride) {
        int64_t j = d + i * s;
        if (j < 0) j += size;
        out[i] = (j >= 0 && j < size) ? win[j] : Bits<T>::of(fill);
    }
}

// ---------------------------------------------------------------------------
// K9 (contiguous) and K10: copy nbytes from src to dst, or zeros when src is
// null (K10's -1 sentinel)

__global__ void copy_bytes_kernel(const uint8_t* __restrict__ src,
                                  uint8_t* __restrict__ dst, int64_t nbytes,
                                  int64_t nvec) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    uint4* dv = reinterpret_cast<uint4*>(dst);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int64_t i = tid; i < nvec; i += stride)
        dv[i] = src != nullptr ? sv[i] : zero;
    for (int64_t i = nvec * 16 + tid; i < nbytes; i += stride)
        dst[i] = src != nullptr ? src[i] : (uint8_t)0;
}

static int copy_bytes(const void* src, void* dst, int64_t nbytes,
                      cudaStream_t s) {
    if (nbytes <= 0) return 0;
    bool vec = (src == nullptr || aligned16(src)) && aligned16(dst);
    int64_t nvec = vec ? nbytes / 16 : 0;
    copy_bytes_kernel<<<grid_for(vec ? nvec : nbytes), OTC_THREADS, 0, s>>>(
        (const uint8_t*)src, (uint8_t*)dst, nbytes, nvec);
    return (int)cudaGetLastError();
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
    ORM_DISPATCH(launch_apply, dtype, op, at, pay, k, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int orm_apply_strided(int dtype, int op, void* win, int64_t size,
                      const void* pay, int64_t k, int64_t d, int64_t s,
                      void* stream) {
    if (k <= 0 || s <= 0) return 0;
    ORM_DISPATCH(launch_apply_strided, dtype, op, win, size, pay, k, d, s,
                 (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int orm_read(int dtype, const void* win, int64_t size, void* out, int64_t k,
             int64_t d, int64_t s, uint32_t fill, void* stream) {
    if (k <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (s == 1) {
        if (k > size) return (int)cudaErrorInvalidValue;
        const char* at = (const char*)win + start(size, k, d) * esize(dtype);
        return copy_bytes(at, out, k * esize(dtype), st);
    }
    switch (dtype) {
    case DT_F32:
        read_strided_kernel<float><<<grid_for(k), OTC_THREADS, 0, st>>>(
            (const float*)win, size, (float*)out, k, d, s, fill);
        break;
    case DT_BF16:
        read_strided_kernel<__nv_bfloat16>
            <<<grid_for(k), OTC_THREADS, 0, st>>>(
                (const __nv_bfloat16*)win, size, (__nv_bfloat16*)out, k, d,
                s, fill);
        break;
    case DT_I32:
        read_strided_kernel<int32_t><<<grid_for(k), OTC_THREADS, 0, st>>>(
            (const int32_t*)win, size, (int32_t*)out, k, d, s, fill);
        break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int orm_permute_recv(const void* src, void* out, int64_t nbytes,
                     void* stream) {
    return copy_bytes(src, out, nbytes, (cudaStream_t)stream);
}

const char* orm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
