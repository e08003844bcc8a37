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
//   otc_block_matmul  K6 the per-block product of allgather_matmul
//                       (_dma_allgather_matmul, body _matmul_body): one
//                       arrived (m, d) block times w (d, f) into the block's
//                       rank-order rows of the output, so no roll is needed.
//
// What bounds them on the H100: HBM bytes. K1 reads 2 and writes 1 (or 2,
// on the last hop) chunk per hop; K2 reads 1 and writes 2; K3 reads n and
// writes 1 slice. None does enough arithmetic to matter. This first version
// is plain: a grid-stride loop of coalesced 16-byte loads and stores (one
// uint4 per thread per step, neighbouring threads on neighbouring addresses),
// no shared-memory tiling, no asynchronous copies; a ragged tail (or a
// pointer that is not 16-byte aligned) takes the same loop one element at a
// time. K5 is bound the same way (it reads carry, own, p and v and writes
// p' and v': six chunks, a handful of flops per element), and takes the
// same loop.
//
// K6 is bound by operations at the main path's shape ((2048, 768) x
// (768, 3072): 9.7 GFLOP against 41 MB). This first version is a plain
// shared-memory tiled GEMM on the CUDA cores: 128 x 128 output tiles, a
// depth of 8 per step, 256 threads each holding an 8 x 8 micro-tile in
// registers (rows ty + 16i, columns tx + 16j, so a warp's shared-memory
// reads are broadcasts or consecutive words). Operands are converted to the
// accumulator type as they enter shared memory: float for float32 and
// bfloat16 (rounded once, at the store), uint32 for int32 (wrapping). No
// tensor cores, no TMA, no overlap of the product with the next hop: those
// are later work.
//
// Numerics (the same as the plain PyTorch versions beside the wrappers, and
// as jnp's per-op rounding):
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
//     op-by-op update bit for bit;
//   - K6's sums run in another order than any library GEMM's; float32 and
//     bfloat16 agree with torch.matmul to a tolerance, int32 exactly.
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

// g = fn(carry, own); g *= inv (has_inv); v' = mu*v + g; g = v' (v given);
// p' = p - lr*g — the op order of _apply_update and of the eager step
template <typename T, int OP>
__device__ __forceinline__ T update_one(T a, T b, T p, const T* v, T vv,
                                        T* vn, T lr, T mu, T inv,
                                        int has_inv) {
    typedef Arith<T> A;
    T g = Combine<T, OP>::f(a, b);
    if (has_inv) g = A::mul(g, inv);
    if (v != nullptr) {
        g = A::add(A::mul(mu, vv), g);
        *vn = g;
    }
    return A::sub(p, A::mul(lr, g));
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
    const Vec<T>* pv = reinterpret_cast<const Vec<T>*>(p);
    const Vec<T>* vv = reinterpret_cast<const Vec<T>*>(v);
    Vec<T>* pov = reinterpret_cast<Vec<T>*>(p_out);
    Vec<T>* vov = reinterpret_cast<Vec<T>*>(v_out);
    for (int64_t i = tid; i < nvec; i += stride) {
        Vec<T> a = cv[i], b = ov[i], pp = pv[i], m, pn, vn;
        if (v != nullptr) m = vv[i];
#pragma unroll
        for (int e = 0; e < V; ++e)
            pn.v[e] = update_one<T, OP>(a.v[e], b.v[e], pp.v[e], v, m.v[e],
                                        &vn.v[e], lr, mu, inv, has_inv);
        pov[i] = pn;
        if (v != nullptr) vov[i] = vn;
    }
    for (int64_t i = nvec * V + tid; i < count; i += stride) {
        T vn;
        T vi = v != nullptr ? v[i] : p[i];
        p_out[i] = update_one<T, OP>(carry[i], own[i], p[i], v, vi, &vn, lr,
                                     mu, inv, has_inv);
        if (v != nullptr) v_out[i] = vn;
    }
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
// K6: out (m, f) = x (m, d) @ w (d, f), all row-major and of one type

#define MM_TILE 128
#define MM_DEPTH 8
#define MM_SUB 8  // micro-tile: MM_SUB x MM_SUB outputs per thread

template <typename T> struct Acc;
template <> struct Acc<float> {
    typedef float type;
    static __device__ __forceinline__ float in(float x) { return x; }
    static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Acc<__nv_bfloat16> {
    typedef float type;
    static __device__ __forceinline__ float in(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    static __device__ __forceinline__ __nv_bfloat16 out(float x) {
        return __float2bfloat16_rn(x);
    }
};
template <> struct Acc<int32_t> {
    typedef uint32_t type;  // wrapping sums of wrapping products
    static __device__ __forceinline__ uint32_t in(int32_t x) {
        return (uint32_t)x;
    }
    static __device__ __forceinline__ int32_t out(uint32_t x) {
        return (int32_t)x;
    }
};

template <typename T>
__global__ void __launch_bounds__(256)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int64_t m, int64_t d, int64_t f) {
    typedef typename Acc<T>::type A;
    // +1 column: the transposed store of x's tile hits 32 banks
    __shared__ A xs[MM_DEPTH][MM_TILE + 1];
    __shared__ A ws[MM_DEPTH][MM_TILE];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int64_t row0 = (int64_t)blockIdx.y * MM_TILE;
    const int64_t col0 = (int64_t)blockIdx.x * MM_TILE;
    A acc[MM_SUB][MM_SUB];
#pragma unroll
    for (int i = 0; i < MM_SUB; ++i)
#pragma unroll
        for (int j = 0; j < MM_SUB; ++j) acc[i][j] = A(0);
    for (int64_t k0 = 0; k0 < d; k0 += MM_DEPTH) {
        // each of the 256 threads brings 4 of x's 128 x 8 tile and 4 of
        // w's 8 x 128 tile; outside the matrices it stores zeros
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int e = threadIdx.x + 256 * q;
            int r = e / MM_DEPTH, kk = e % MM_DEPTH;
            int64_t gr = row0 + r, gk = k0 + kk;
            xs[kk][r] = (gr < m && gk < d) ? Acc<T>::in(x[gr * d + gk]) : A(0);
            int kw = e / MM_TILE, c = e % MM_TILE;
            int64_t gkw = k0 + kw, gc = col0 + c;
            ws[kw][c] = (gkw < d && gc < f) ? Acc<T>::in(w[gkw * f + gc]) : A(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < MM_DEPTH; ++kk) {
            A a[MM_SUB], b[MM_SUB];
#pragma unroll
            for (int i = 0; i < MM_SUB; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < MM_SUB; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < MM_SUB; ++i)
#pragma unroll
                for (int j = 0; j < MM_SUB; ++j) acc[i][j] += a[i] * b[j];
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MM_SUB; ++i) {
        int64_t gr = row0 + ty + 16 * i;
        if (gr >= m) continue;
#pragma unroll
        for (int j = 0; j < MM_SUB; ++j) {
            int64_t gc = col0 + tx + 16 * j;
            if (gc < f) out[gr * f + gc] = Acc<T>::out(acc[i][j]);
        }
    }
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

int otc_block_matmul(int dtype, const void* x, const void* w, void* out,
                     int64_t m, int64_t d, int64_t f, void* stream) {
    if (m <= 0 || f <= 0) return 0;
    if (d < 0 || (f + MM_TILE - 1) / MM_TILE > 0x7fffffff ||
        (m + MM_TILE - 1) / MM_TILE > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((f + MM_TILE - 1) / MM_TILE),
              (unsigned)((m + MM_TILE - 1) / MM_TILE));
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
    case DT_F32:
        matmul_kernel<float><<<grid, 256, 0, s>>>(
            (const float*)x, (const float*)w, (float*)out, m, d, f);
        break;
    case DT_BF16:
        matmul_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)out, m, d, f);
        break;
    case DT_I32:
        matmul_kernel<int32_t><<<grid, 256, 0, s>>>(
            (const int32_t*)x, (const int32_t*)w, (int32_t*)out, m, d, f);
        break;
    default: return (int)cudaErrorInvalidValue;
    }
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
