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
//   otc_rs_update_hop K5 the last hop of ring_reduce_scatter_update
//                       (_dma_reduce_scatter_update, bodies
//                       _combine_update_body / _apply_update): g = fn(carry,
//                       own), then the ZeRO shard update g *= inv;
//                       v' = mu*v + g; p' = p - lr*v' (v and inv optional),
//                       so the reduced chunk never reaches memory.
//   otc_linear_fold_update K5b  linear_reduce_scatter_update
//                       (_fold_slice_update_body, _apply_update): K3's
//                       rank-order fold of every rank's own slice, then
//                       K5's update epilogue, in one pass; the folded
//                       chunk never reaches memory. Nothing in the JAX
//                       package calls it (its 'linear' fused slot runs K3
//                       and an eager update), so no path of the port does.
//
// K6, the block product of allgather_matmul, lives in gemm_kernels.cu.
//
// What bounds them on the H100: HBM bytes. K1 reads 2 and writes 1 (or 2,
// on the last hop) chunk per hop: 3 or 4 chunks; K2 reads 1 and writes 2;
// K3 reads n and writes 1 slice. None does enough arithmetic to matter.
// K1 runs on the streaming engine of stream.cuh: one block per 16 KiB tile
// of carry and of own, each thread issuing its four 16-byte loads of both
// before it combines, streaming cache hints, the grid the tile count (one
// vector a thread below 1 MiB). The first port's grid-stride loop held one
// vector of each per thread per trip on a grid capped at 132 x 16 blocks,
// and reached 84% of the bound on the device at a 64 MiB chunk; the engine
// reaches 87%, as torch.add does (PERF.md section 6, scripts/stream_ab.py).
// The engine's head and tail element loops take a ragged end or pointers
// one element off 16 bytes, in the same launch. K2, K3 and K5 keep the first
// port's plain loop: a grid-stride loop of coalesced 16-byte loads and
// stores (one uint4 per thread per step), a ragged tail (or a pointer
// that is not 16-byte aligned) one element at a time. K5 reads carry, own,
// p and v and writes p' and v': six chunks, a handful of flops per
// element; K5b reads n slices, p and v and writes p' and v'.
//
// Numerics (the same as the plain PyTorch versions beside the wrappers, and
// as jnp's per-op rounding; the elementwise combine lives in combine.cuh,
// which osc/csrc/rma_kernels.cu shares):
//   - bf16 rounds to bf16 after every combine (__float2bfloat16_rn); no f32
//     value is carried across the fold;
//   - f32 uses __fadd_rn / __fmul_rn, so nothing is contracted into an FMA;
//   - MIN / MAX propagate NaN (the first NaN operand is returned), and order
//     -0 below +0, as jnp.minimum / jnp.maximum do; fminf / fmaxf do
//     neither, so the compare is written out;
//   - int32 SUM / PROD wrap around (computed in uint32);
//   - K5's update takes its constants (lr, mu, inv) as bit patterns already
//     cast to the shard's type by the caller (1/3 rounds to bfloat16, and
//     truncates to 0 for int32, as jnp.asarray(inv, dtype) does), and rounds
//     after every op exactly like K1's combine, so it equals the eager,
//     op-by-op update bit for bit; K5b shares the same epilogue, so it
//     equals K3 followed by the eager update bit for bit.
//
// Every entry point returns a cudaError_t as int: 0 on success, else the
// error of the call or of the launch (cudaGetLastError()).

#include "stream.cuh"

#define OTC_MAX_PEERS 64

// K1, dst = fn(carry, own) (and dst2, the output, on a ring's last hop), is
// stream.cuh's stream_launch<T, OP>(carry, own, dst, dst2, count, stream).

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

// element i of the fold (16-byte vector i, and one element i), shared by
// K3 and K5b
template <typename T, int OP>
__device__ __forceinline__ Vec<T> fold_vec(const Srcs& srcs, int n,
                                           int64_t i) {
    constexpr int V = 16 / sizeof(T);
    Vec<T> acc = reinterpret_cast<const Vec<T>*>(srcs.p[0])[i];
    for (int j = 1; j < n; ++j) {
        Vec<T> b = reinterpret_cast<const Vec<T>*>(srcs.p[j])[i];
#pragma unroll
        for (int e = 0; e < V; ++e)
            acc.v[e] = Combine<T, OP>::f(acc.v[e], b.v[e]);
    }
    return acc;
}

template <typename T, int OP>
__device__ __forceinline__ T fold_one(const Srcs& srcs, int n, int64_t i) {
    T acc = reinterpret_cast<const T*>(srcs.p[0])[i];
    for (int j = 1; j < n; ++j)
        acc = Combine<T, OP>::f(acc, reinterpret_cast<const T*>(srcs.p[j])[i]);
    return acc;
}

template <typename T, int OP>
__global__ void fold_kernel(Srcs srcs, int n, T* __restrict__ dst,
                            int64_t count, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    Vec<T>* dv = reinterpret_cast<Vec<T>*>(dst);
    for (int64_t i = tid; i < nvec; i += stride)
        dv[i] = fold_vec<T, OP>(srcs, n, i);
    for (int64_t i = nvec * V + tid; i < count; i += stride)
        dst[i] = fold_one<T, OP>(srcs, n, i);
}

static bool srcs_aligned16(const Srcs& srcs, int n) {
    for (int j = 0; j < n; ++j)
        if (!aligned16(srcs.p[j])) return false;
    return true;
}

template <typename T, int OP>
static void launch_fold(const Srcs& srcs, int n, void* dst, int64_t count,
                        cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = aligned16(dst) && srcs_aligned16(srcs, n);
    int64_t nvec = vec ? count / V : 0;
    fold_kernel<T, OP><<<grid_for(vec ? nvec : count), OTC_THREADS, 0, s>>>(
        srcs, n, (T*)dst, count, nvec);
}

// ---------------------------------------------------------------------------
// K5: the last reduce-scatter hop fused with the ZeRO shard update

// one correctly rounded op at a time, per type (no contraction into FMA)
template <typename T> struct Arith;
template <> struct Arith<float> {
    static __device__ __forceinline__ float from_bits(uint32_t b) {
        return __uint_as_float(b);
    }
    static __device__ __forceinline__ float mul(float a, float b) {
        return __fmul_rn(a, b);
    }
    static __device__ __forceinline__ float add(float a, float b) {
        return __fadd_rn(a, b);
    }
    static __device__ __forceinline__ float sub(float a, float b) {
        return __fsub_rn(a, b);
    }
};
template <> struct Arith<__nv_bfloat16> {
    typedef __nv_bfloat16 T;
    static __device__ __forceinline__ T from_bits(uint32_t b) {
        return __ushort_as_bfloat16((unsigned short)b);
    }
    static __device__ __forceinline__ T mul(T a, T b) {
        return __float2bfloat16_rn(
            __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
    }
    static __device__ __forceinline__ T add(T a, T b) {
        return __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
    }
    static __device__ __forceinline__ T sub(T a, T b) {
        return __float2bfloat16_rn(
            __fsub_rn(__bfloat162float(a), __bfloat162float(b)));
    }
};
template <> struct Arith<int32_t> {
    static __device__ __forceinline__ int32_t from_bits(uint32_t b) {
        return (int32_t)b;
    }
    static __device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
        return (int32_t)((uint32_t)a * (uint32_t)b);
    }
    static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
        return (int32_t)((uint32_t)a + (uint32_t)b);
    }
    static __device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
        return (int32_t)((uint32_t)a - (uint32_t)b);
    }
};

// g *= inv (has_inv); v' = mu*v + g; g = v' (v given); p' = p - lr*g —
// the op order of _apply_update and of the eager step. The epilogue of K5
// and K5b.
template <typename T>
__device__ __forceinline__ T apply_update(T g, T p, const T* v, T vv, T* vn,
                                          T lr, T mu, T inv, int has_inv) {
    typedef Arith<T> A;
    if (has_inv) g = A::mul(g, inv);
    if (v != nullptr) {
        g = A::add(A::mul(mu, vv), g);
        *vn = g;
    }
    return A::sub(p, A::mul(lr, g));
}

// the update of one 16-byte vector i, g given: p_out[i] (and v_out[i])
template <typename T>
__device__ __forceinline__ void apply_update_vec(
    const Vec<T>& g, int64_t i, const T* __restrict__ p,
    const T* __restrict__ v, T* __restrict__ p_out, T* __restrict__ v_out,
    T lr, T mu, T inv, int has_inv) {
    constexpr int V = 16 / sizeof(T);
    Vec<T> pp = reinterpret_cast<const Vec<T>*>(p)[i], m, pn, vn;
    if (v != nullptr) m = reinterpret_cast<const Vec<T>*>(v)[i];
#pragma unroll
    for (int e = 0; e < V; ++e)
        pn.v[e] = apply_update<T>(g.v[e], pp.v[e], v, m.v[e], &vn.v[e], lr,
                                  mu, inv, has_inv);
    reinterpret_cast<Vec<T>*>(p_out)[i] = pn;
    if (v != nullptr) reinterpret_cast<Vec<T>*>(v_out)[i] = vn;
}

template <typename T>
__device__ __forceinline__ void apply_update_one(
    T g, int64_t i, const T* __restrict__ p, const T* __restrict__ v,
    T* __restrict__ p_out, T* __restrict__ v_out, T lr, T mu, T inv,
    int has_inv) {
    T vn;
    T vi = v != nullptr ? v[i] : p[i];
    p_out[i] = apply_update<T>(g, p[i], v, vi, &vn, lr, mu, inv, has_inv);
    if (v != nullptr) v_out[i] = vn;
}

template <typename T, int OP>
__global__ void rs_update_kernel(const T* __restrict__ carry,
                                 const T* __restrict__ own,
                                 const T* __restrict__ p,
                                 const T* __restrict__ v,
                                 T* __restrict__ p_out,
                                 T* __restrict__ v_out, uint32_t lr_bits,
                                 uint32_t mu_bits, uint32_t inv_bits,
                                 int has_inv, int64_t count, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    typedef Arith<T> A;
    const T lr = A::from_bits(lr_bits), mu = A::from_bits(mu_bits),
            inv = A::from_bits(inv_bits);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const Vec<T>* cv = reinterpret_cast<const Vec<T>*>(carry);
    const Vec<T>* ov = reinterpret_cast<const Vec<T>*>(own);
    for (int64_t i = tid; i < nvec; i += stride) {
        Vec<T> a = cv[i], b = ov[i], g;
#pragma unroll
        for (int e = 0; e < V; ++e) g.v[e] = Combine<T, OP>::f(a.v[e], b.v[e]);
        apply_update_vec<T>(g, i, p, v, p_out, v_out, lr, mu, inv, has_inv);
    }
    for (int64_t i = nvec * V + tid; i < count; i += stride)
        apply_update_one<T>(Combine<T, OP>::f(carry[i], own[i]), i, p, v,
                            p_out, v_out, lr, mu, inv, has_inv);
}

template <typename T, int OP>
static void launch_rs_update(const void* carry, const void* own,
                             const void* p, const void* v, void* p_out,
                             void* v_out, uint32_t lr, uint32_t mu,
                             uint32_t inv, int has_inv, int64_t count,
                             cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = aligned16(carry) && aligned16(own) && aligned16(p) &&
               aligned16(p_out) &&
               (v == nullptr || (aligned16(v) && aligned16(v_out)));
    int64_t nvec = vec ? count / V : 0;
    rs_update_kernel<T, OP>
        <<<grid_for(vec ? nvec : count), OTC_THREADS, 0, s>>>(
            (const T*)carry, (const T*)own, (const T*)p, (const T*)v,
            (T*)p_out, (T*)v_out, lr, mu, inv, has_inv, count, nvec);
}

// ---------------------------------------------------------------------------
// K5b: the rank-order fold of every rank's own slice fused with the update

template <typename T, int OP>
__global__ void fold_update_kernel(Srcs srcs, int n,
                                   const T* __restrict__ p,
                                   const T* __restrict__ v,
                                   T* __restrict__ p_out,
                                   T* __restrict__ v_out, uint32_t lr_bits,
                                   uint32_t mu_bits, uint32_t inv_bits,
                                   int has_inv, int64_t count, int64_t nvec) {
    constexpr int V = 16 / sizeof(T);
    typedef Arith<T> A;
    const T lr = A::from_bits(lr_bits), mu = A::from_bits(mu_bits),
            inv = A::from_bits(inv_bits);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    for (int64_t i = tid; i < nvec; i += stride)
        apply_update_vec<T>(fold_vec<T, OP>(srcs, n, i), i, p, v, p_out,
                            v_out, lr, mu, inv, has_inv);
    for (int64_t i = nvec * V + tid; i < count; i += stride)
        apply_update_one<T>(fold_one<T, OP>(srcs, n, i), i, p, v, p_out,
                            v_out, lr, mu, inv, has_inv);
}

template <typename T, int OP>
static void launch_fold_update(const Srcs& srcs, int n, const void* p,
                               const void* v, void* p_out, void* v_out,
                               uint32_t lr, uint32_t mu, uint32_t inv,
                               int has_inv, int64_t count, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool vec = srcs_aligned16(srcs, n) && aligned16(p) && aligned16(p_out) &&
               (v == nullptr || (aligned16(v) && aligned16(v_out)));
    int64_t nvec = vec ? count / V : 0;
    fold_update_kernel<T, OP>
        <<<grid_for(vec ? nvec : count), OTC_THREADS, 0, s>>>(
            srcs, n, (const T*)p, (const T*)v, (T*)p_out, (T*)v_out, lr, mu,
            inv, has_inv, count, nvec);
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
    int rc = 0;
    OTC_DISPATCH(rc = stream_launch, dtype, op, carry, own, dst, dst2, count,
                 (cudaStream_t)stream);
    return rc;
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

static Srcs make_srcs(const void* const* srcs, int n) {
    Srcs s;
    for (int j = 0; j < OTC_MAX_PEERS; ++j) s.p[j] = j < n ? srcs[j] : nullptr;
    return s;
}

int otc_linear_fold(int dtype, int op, const void* const* srcs, int n,
                    void* dst, int64_t count, void* stream) {
    if (n < 1 || n > OTC_MAX_PEERS) return (int)cudaErrorInvalidValue;
    if (count <= 0) return 0;
    Srcs s = make_srcs(srcs, n);
    OTC_DISPATCH(launch_fold, dtype, op, s, n, dst, count,
                 (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int otc_rs_update_hop(int dtype, int op, const void* carry, const void* own,
                      const void* p, const void* v, void* p_out, void* v_out,
                      uint32_t lr_bits, uint32_t mu_bits, uint32_t inv_bits,
                      int has_inv, int64_t count, void* stream) {
    if (count <= 0) return 0;
    if ((v == nullptr) != (v_out == nullptr)) return (int)cudaErrorInvalidValue;
    OTC_DISPATCH(launch_rs_update, dtype, op, carry, own, p, v, p_out, v_out,
                 lr_bits, mu_bits, inv_bits, has_inv, count,
                 (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

int otc_linear_fold_update(int dtype, int op, const void* const* srcs,
                           int n, const void* p, const void* v, void* p_out,
                           void* v_out, uint32_t lr_bits, uint32_t mu_bits,
                           uint32_t inv_bits, int has_inv, int64_t count,
                           void* stream) {
    if (n < 1 || n > OTC_MAX_PEERS) return (int)cudaErrorInvalidValue;
    if (count <= 0) return 0;
    if ((v == nullptr) != (v_out == nullptr)) return (int)cudaErrorInvalidValue;
    Srcs s = make_srcs(srcs, n);
    OTC_DISPATCH(launch_fold_update, dtype, op, s, n, p, v, p_out, v_out,
                 lr_bits, mu_bits, inv_bits, has_inv, count,
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
