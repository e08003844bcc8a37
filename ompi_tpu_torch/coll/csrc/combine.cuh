// combine.cuh — what every kernel source of ompi_tpu_torch shares: the
// dtype and op codes of the ctypes interface, the elementwise combine with
// jnp's numerics (see ring_kernels.cu's header), 16-byte vectors and the
// grid size of a grid-stride loop. Included by coll/csrc/ring_kernels.cu
// (K1-K6) and osc/csrc/rma_kernels.cu (K7-K10).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };
enum { OP_SUM = 0, OP_PROD = 1, OP_MIN = 2, OP_MAX = 3 };

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

