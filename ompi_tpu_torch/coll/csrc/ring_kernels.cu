// ring_kernels.cu — the ring collective kernels of ompi_tpu_torch.coll,
// written by hand for Hopper (sm_90a), with a plain C interface that
// ompi_tpu_torch/coll/cuda_kernels.py loads with ctypes.
//
// Replaces (JAX package, ompi_tpu/coll/pallas_kernels.py):
//   otc_rs_hop      K1  one hop of ring_reduce_scatter (_dma_reduce_scatter,
//                       body _combine_body): dst = fn(carry, own), with the
//                       carry read straight from the ring neighbour's arena
//                       slot through its peer pointer — the peer read takes
//                       the place of make_async_remote_copy. Operand order
//                       (carry, own) as at pallas_kernels.py:550.
//   otc_ag_hop      K2  one hop of ring_allgather (_dma_allgather): copy the
//                       block the neighbour holds into the own slot and into
//                       the output at its rank-order position, so the output
//                       needs no roll (_roll_body).
//   otc_linear_fold K3  linear_allreduce / linear_reduce_scatter (_fold_body,
//                       _fold_slice_body): acc = g0; acc = fn(acc, g_i) for
//                       i = 1..n-1, reading every rank's staged input through
//                       its peer pointer, so the [n, ...] stack that
//                       _gather_stack builds is never written to memory.
//
// What bounds them on the H100: HBM bytes. K1 reads 2 and writes 1 (or 2,
// on the last hop) chunk per hop; K2 reads 1 and writes 2; K3 reads n and
// writes 1 slice. None does enough arithmetic to matter. This first version
// is plain: a grid-stride loop of coalesced 16-byte loads and stores (one
// uint4 per thread per step, neighbouring threads on neighbouring addresses),
// no shared-memory tiling, no asynchronous copies; a ragged tail (or a
// pointer that is not 16-byte aligned) takes the same loop one element at a
// time.
//
// Numerics (the same as the plain PyTorch versions beside the wrappers, and
// as jnp's per-op rounding):
//   - bf16 rounds to bf16 after every combine (__float2bfloat16_rn); no f32
//     value is carried across the fold;
//   - f32 uses __fadd_rn / __fmul_rn, so nothing is contracted into an FMA;
//   - MIN / MAX propagate NaN (the first NaN operand is returned), and order
//     -0 below +0, as jnp.minimum / jnp.maximum do; fminf / fmaxf do
//     neither, so the compare is written out;
//   - int32 SUM / PROD wrap around (computed in uint32).
//
// Every entry point returns a cudaError_t as int: 0 on success, else the
// error of the call or of the launch (cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };
enum { OP_SUM = 0, OP_PROD = 1, OP_MIN = 2, OP_MAX = 3 };

#define OTC_MAX_PEERS 64
#define OTC_THREADS 256
#define OTC_MAX_BLOCKS (132 * 16)

// ---------------------------------------------------------------------------
// the elementwise combine, per type and op

template <int OP>
__device__ __forceinline__ float combine_f32(float a, float b) {
    if (OP == OP_SUM) return __fadd_rn(a, b);
    if (OP == OP_PROD) return __fmul_rn(a, b);
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    if (OP == OP_MIN) {
        if (a < b) return a;
        if (b < a) return b;
        return signbit(a) ? a : b;  // equal: -0 is the smaller
    }
    if (a > b) return a;
    if (b > a) return b;
    return signbit(a) ? b : a;  // equal: +0 is the larger
}

template <int OP>
__device__ __forceinline__ __nv_bfloat16 combine_bf16(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    float fa = __bfloat162float(a), fb = __bfloat162float(b);
    if (OP == OP_SUM) return __float2bfloat16_rn(__fadd_rn(fa, fb));
    if (OP == OP_PROD) return __float2bfloat16_rn(__fmul_rn(fa, fb));
    // MIN / MAX select an operand, so its bits pass through unchanged
    if (isnan(fa)) return a;
    if (isnan(fb)) return b;
    if (OP == OP_MIN) {
        if (fa < fb) return a;
        if (fb < fa) return b;
        return signbit(fa) ? a : b;
    }
    if (fa > fb) return a;
    if (fb > fa) return b;
    return signbit(fa) ? b : a;
}

template <int OP>
__device__ __forceinline__ int32_t combine_i32(int32_t a, int32_t b) {
    if (OP == OP_SUM) return (int32_t)((uint32_t)a + (uint32_t)b);
    if (OP == OP_PROD) return (int32_t)((uint32_t)a * (uint32_t)b);
    if (OP == OP_MIN) return a < b ? a : b;
    return a > b ? a : b;
}

template <typename T, int OP> struct Combine;
template <int OP> struct Combine<float, OP> {
    static __device__ __forceinline__ float f(float a, float b) {
        return combine_f32<OP>(a, b);
    }
};
template <int OP> struct Combine<__nv_bfloat16, OP> {
    static __device__ __forceinline__ __nv_bfloat16 f(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
        return combine_bf16<OP>(a, b);
    }
};
template <int OP> struct Combine<int32_t, OP> {
    static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
        return combine_i32<OP>(a, b);
    }
};

// 16 bytes of T: one uint4 load or store
template <typename T> struct alignas(16) Vec {
    T v[16 / sizeof(T)];
};

static inline int grid_for(int64_t items) {
    int64_t b = (items + OTC_THREADS - 1) / OTC_THREADS;
    if (b < 1) b = 1;
    if (b > OTC_MAX_BLOCKS) b = OTC_MAX_BLOCKS;
    return (int)b;
}

static inline bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// ---------------------------------------------------------------------------
// K1: dst = fn(carry, own) (and dst2, the output, on a ring's last hop)

template <typename T, int OP>
__global__ void rs_hop_kernel(const T* __restrict__ carry,
                              const T* __restrict__ own,
                              T* __restrict__ dst, T* __restrict__ dst2,
                              int64_t count, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const Vec<T>* cv = reinterpret_cast<const Vec<T>*>(carry);
    const Vec<T>* ov = reinterpret_cast<const Vec<T>*>(own);
    Vec<T>* dv = reinterpret_cast<Vec<T>*>(dst);
    Vec<T>* d2v = reinterpret_cast<Vec<T>*>(dst2);
    for (int64_t i = tid; i < nvec; i += stride) {
        Vec<T> a = cv[i], b = ov[i], r;
#pragma unroll
        for (int e = 0; e < V; ++e) r.v[e] = Combine<T, OP>::f(a.v[e], b.v[e]);
        dv[i] = r;
        if (dst2 != nullptr) d2v[i] = r;
    }
    for (int64_t i = nvec * V + tid; i < count; i += stride) {
        T r = Combine<T, OP>::f(carry[i], own[i]);
        dst[i] = r;
        if (dst2 != nullptr) dst2[i] = r;
    }
}

template <typename T, int OP>
static void launch_rs(const void* carry, const void* own, void* dst,
                      void* dst2, int64_t count, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = aligned16(carry) && aligned16(own) && aligned16(dst) &&
               (dst2 == nullptr || aligned16(dst2));
    int64_t nvec = vec ? count / V : 0;
    rs_hop_kernel<T, OP><<<grid_for(vec ? nvec : count), OTC_THREADS, 0, s>>>(
        (const T*)carry, (const T*)own, (T*)dst, (T*)dst2, count, nvec);
}

// ---------------------------------------------------------------------------
// K2: dst = src (and dst2, the output position)

__global__ void ag_hop_kernel(const uint8_t* __restrict__ src,
                              uint8_t* __restrict__ dst,
                              uint8_t* __restrict__ dst2, int64_t nbytes,
                              int64_t nvec) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    uint4* dv = reinterpret_cast<uint4*>(dst);
    uint4* d2v = reinterpret_cast<uint4*>(dst2);
    for (int64_t i = tid; i < nvec; i += stride) {
        uint4 x = sv[i];
        dv[i] = x;
        if (dst2 != nullptr) d2v[i] = x;
    }
    for (int64_t i = nvec * 16 + tid; i < nbytes; i += stride) {
        uint8_t x = src[i];
        dst[i] = x;
        if (dst2 != nullptr) dst2[i] = x;
    }
}

// ---------------------------------------------------------------------------
// K3: dst = fold over n sources in rank order

struct Srcs {
    const void* p[OTC_MAX_PEERS];
};

template <typename T, int OP>
__global__ void fold_kernel(Srcs srcs, int n, T* __restrict__ dst,
                            int64_t count, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    Vec<T>* dv = reinterpret_cast<Vec<T>*>(dst);
    for (int64_t i = tid; i < nvec; i += stride) {
        Vec<T> acc = reinterpret_cast<const Vec<T>*>(srcs.p[0])[i];
        for (int j = 1; j < n; ++j) {
            Vec<T> b = reinterpret_cast<const Vec<T>*>(srcs.p[j])[i];
#pragma unroll
            for (int e = 0; e < V; ++e)
                acc.v[e] = Combine<T, OP>::f(acc.v[e], b.v[e]);
        }
        dv[i] = acc;
    }
    for (int64_t i = nvec * V + tid; i < count; i += stride) {
        T acc = reinterpret_cast<const T*>(srcs.p[0])[i];
        for (int j = 1; j < n; ++j)
            acc = Combine<T, OP>::f(acc, reinterpret_cast<const T*>(srcs.p[j])[i]);
        dst[i] = acc;
    }
}

template <typename T, int OP>
static void launch_fold(const Srcs& srcs, int n, void* dst, int64_t count,
                        cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = aligned16(dst);
    for (int j = 0; j < n; ++j) vec = vec && aligned16(srcs.p[j]);
    int64_t nvec = vec ? count / V : 0;
    fold_kernel<T, OP><<<grid_for(vec ? nvec : count), OTC_THREADS, 0, s>>>(
        srcs, n, (T*)dst, count, nvec);
}

// dispatch a templated launcher over (dtype, op); false = unknown pair
#define OTC_DISPATCH(LAUNCH, dtype, op, ...)                               \
    do {                                                                   \
        switch ((dtype) * 4 + (op)) {                                      \
        case DT_F32 * 4 + OP_SUM: LAUNCH<float, OP_SUM>(__VA_ARGS__); break;  \
        case DT_F32 * 4 + OP_PROD: LAUNCH<float, OP_PROD>(__VA_ARGS__); break; \
        case DT_F32 * 4 + OP_MIN: LAUNCH<float, OP_MIN>(__VA_ARGS__); break;  \
        case DT_F32 * 4 + OP_MAX: LAUNCH<float, OP_MAX>(__VA_ARGS__); break;  \
        case DT_BF16 * 4 + OP_SUM:                                         \
            LAUNCH<__nv_bfloat16, OP_SUM>(__VA_ARGS__); break;             \
        case DT_BF16 * 4 + OP_PROD:                                        \
            LAUNCH<__nv_bfloat16, OP_PROD>(__VA_ARGS__); break;            \
        case DT_BF16 * 4 + OP_MIN:                                         \
            LAUNCH<__nv_bfloat16, OP_MIN>(__VA_ARGS__); break;             \
        case DT_BF16 * 4 + OP_MAX:                                         \
            LAUNCH<__nv_bfloat16, OP_MAX>(__VA_ARGS__); break;             \
        case DT_I32 * 4 + OP_SUM: LAUNCH<int32_t, OP_SUM>(__VA_ARGS__); break; \
        case DT_I32 * 4 + OP_PROD: LAUNCH<int32_t, OP_PROD>(__VA_ARGS__); break; \
        case DT_I32 * 4 + OP_MIN: LAUNCH<int32_t, OP_MIN>(__VA_ARGS__); break; \
        case DT_I32 * 4 + OP_MAX: LAUNCH<int32_t, OP_MAX>(__VA_ARGS__); break; \
        default: return (int)cudaErrorInvalidValue;                        \
        }                                                                  \
    } while (0)

extern "C" {

int otc_rs_hop(int dtype, int op, const void* carry, const void* own,
               void* dst, void* dst2, int64_t count, void* stream) {
    if (count <= 0) return 0;
    OTC_DISPATCH(launch_rs, dtype, op, carry, own, dst, dst2, count,
                 (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int otc_ag_hop(const void* src, void* dst, void* dst2, int64_t nbytes,
               void* stream) {
    if (nbytes <= 0) return 0;
    bool vec = aligned16(src) && aligned16(dst) &&
               (dst2 == nullptr || aligned16(dst2));
    int64_t nvec = vec ? nbytes / 16 : 0;
    ag_hop_kernel<<<grid_for(vec ? nvec : nbytes), OTC_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)src, (uint8_t*)dst, (uint8_t*)dst2, nbytes, nvec);
    return (int)cudaGetLastError();
}

int otc_linear_fold(int dtype, int op, const void* const* srcs, int n,
                    void* dst, int64_t count, void* stream) {
    if (n < 1 || n > OTC_MAX_PEERS) return (int)cudaErrorInvalidValue;
    if (count <= 0) return 0;
    Srcs s;
    for (int j = 0; j < OTC_MAX_PEERS; ++j) s.p[j] = j < n ? srcs[j] : nullptr;
    OTC_DISPATCH(launch_fold, dtype, op, s, n, dst, count,
                 (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int otc_max_peers(void) { return OTC_MAX_PEERS; }

// -- arenas: device memory outside PyTorch's caching allocator, so that
//    cudaIpcGetMemHandle sees a whole allocation of its own

int otc_set_device(int device) { return (int)cudaSetDevice(device); }

int otc_malloc(int64_t nbytes, void** out) {
    cudaError_t e = cudaMalloc(out, (size_t)nbytes);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemset(*out, 0, (size_t)nbytes);
}

int otc_free(void* p) { return (int)cudaFree(p); }

int otc_ipc_handle_size(void) { return (int)sizeof(cudaIpcMemHandle_t); }

int otc_ipc_get_handle(void* p, void* handle_out) {
    return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle_out, p);
}

int otc_ipc_open(const void* handle, void** out) {
    cudaIpcMemHandle_t h = *(const cudaIpcMemHandle_t*)handle;
    return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int otc_ipc_close(void* p) { return (int)cudaIpcCloseMemHandle(p); }

const char* otc_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
