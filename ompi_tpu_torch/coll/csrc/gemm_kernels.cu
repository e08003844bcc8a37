// gemm_kernels.cu — K6, the block product of allgather_matmul, written by
// hand for Hopper (sm_90a), with a plain C interface that
// ompi_tpu_torch/coll/cuda_kernels.py loads with ctypes.
//
// Replaces (JAX package, ompi_tpu/coll/pallas_kernels.py): the per-block
// product of _dma_allgather_matmul (:659, body _matmul_body :112): one
// arrived (m, d) block x times the weight w (d, f) into the block's
// rank-order rows of the output, all row-major and of one type.
//
// What bounds it on the H100: operations. At the main path's shape
// ((2048, 768) @ (768, 3072), 9.7 GFLOP against 12-25 MB) the product needs
// 0.0098 ms at the bfloat16 tensor-core peak (989 TFLOP/s) and 0.144 ms at
// the float32 CUDA-core peak (67 TFLOP/s); the bytes take 0.004-0.008 ms.
// Below those peaks, what each tile draws from L2 counts: 128 x 128 tiles
// over K = 768 read 147 MB from L2 for the bfloat16 product.
// Two kernels, chosen by a shape rule in Python
// (cuda_kernels.block_matmul_variant):
//
//   otc_wgmma_matmul  bfloat16 on the tensor cores. A 128 x 128 output tile
//       per block, float32 accumulators in registers, K advancing 64 values
//       per stage through a ring of 4 stages in dynamic shared memory (an
//       A tile and a B tile, 32 KiB a stage). Warpgroup 0 is the producer:
//       one thread issues the TMA loads (cp.async.bulk.tensor.2d, 128-byte
//       swizzle) and arms the stage's "full" mbarrier with the whole box's
//       bytes (out-of-bounds parts of a ragged box arrive as zeros and
//       count). Warpgroups 1 and 2 each take 64 rows of the tile: four
//       wgmma.mma_async m64n128k16 per stage, reading x K-major and w
//       MN-major (the descriptor's transpose bit, so w needs no copy), then
//       release the stage through its "empty" mbarrier. The tensor maps are
//       encoded on the host per launch (the block's base pointer moves with
//       every ring hop) through cuTensorMapEncodeTiled, found with
//       cudaGetDriverEntryPoint (no -lcuda), and passed as
//       __grid_constant__ parameters. The epilogue rounds once to bfloat16
//       and stores straight from registers. The kernel is persistent (one
//       block per SM walks the tiles), and the consumers keep one stage's
//       products in flight (wgmma.wait_group 1) while issuing the next,
//       so the producer loads the next tile during this tile's epilogue.
//   otc_simt_matmul   float32, int32 (wrapping), and bfloat16 shapes TMA
//       cannot take (rows not a multiple of 16 bytes, unaligned views): a
//       register-tiled kernel on the CUDA cores. 128 x 128 block tiles, 256
//       threads each holding an 8 x 8 micro-tile whose A and B fragments it
//       reads from shared memory as 16-byte vectors; K advances 16 per
//       stage; the next stage's global loads are issued into registers
//       before this stage's FMAs and stored into the other half of a double
//       buffer after them, so one barrier per stage. Full float32 FMAs,
//       never TF32. Where the 128 x 128 tiles cover fewer blocks than the
//       card has SMs (the zero-3 product, (192, 3072) @ (3072, 256): 4
//       tiles), the wrapper splits K into slices (gridDim.z) whose partial
//       sums go to a scratch buffer the wrapper allocates, and a second pass
//       adds them in slice order.
//
// Numerics: float32 and bfloat16 sum in float32 in another order than any
// library GEMM, so they agree with torch.matmul to a tolerance; bfloat16
// rounds once, at the store; int32 is exact (mod 2**32 in any order).
//
// Every entry point returns a cudaError_t as int: 0 on success, else the
// error of the call or of the launch (cudaGetLastError()); a tensor map
// that cannot be encoded returns OTC_ERR_TENSOR_MAP.

#include "combine.cuh"

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up

#define OTC_ERR_TENSOR_MAP 100001
#define OTC_ERR_NO_ENCODER 100002
#define OTC_MAX_DEVICES 64

// ---------------------------------------------------------------------------
// the accumulator per type

template <typename T> struct Acc;
template <> struct Acc<float> {
    typedef float type;
    static __device__ __forceinline__ float in(float x) { return x; }
    static __device__ __forceinline__ float out(float x) { return x; }
    static __device__ __forceinline__ float fma(float a, float b, float c) {
        return fmaf(a, b, c);
    }
};
template <> struct Acc<__nv_bfloat16> {
    typedef float type;
    static __device__ __forceinline__ float in(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    static __device__ __forceinline__ __nv_bfloat16 out(float x) {
        return __float2bfloat16_rn(x);
    }
    static __device__ __forceinline__ float fma(float a, float b, float c) {
        return fmaf(a, b, c);
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
    static __device__ __forceinline__ uint32_t fma(uint32_t a, uint32_t b,
                                                   uint32_t c) {
        return a * b + c;
    }
};

// ---------------------------------------------------------------------------
// otc_wgmma_matmul: bfloat16 through TMA and wgmma

#define WG_BM 128
#define WG_BN 128
#define WG_BK 64  // 64 bfloat16 = one 128-byte swizzled row
#define WG_STAGES 4
#define WG_THREADS 384  // warpgroup 0 produces, 1 and 2 consume

constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;   // 16 KiB
constexpr int WG_B_BOX = WG_BK * 64 * 2;        // one 64-column box, 8 KiB
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;   // 16 KiB
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
// + 1 KiB to align the ring to the 128-byte swizzle's 1024-byte period
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase differs from ``parity``
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// box (c0 innermost, c1) of the map into shared memory, completing on bar
static __device__ __forceinline__ void tma_load(void* dst,
                                                const CUtensorMap* map,
                                                int c0, int c1,
                                                uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
           "r"(c0), "r"(c1)
        : "memory");
}

// a wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units
static __device__ __forceinline__ uint64_t desc128(const void* p,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
           ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
           (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16, K-major) @ B (16 x 128, MN-major)
static __device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                        uint64_t da,
                                                        uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63 "
        "}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// pin the accumulators in program order around the asynchronous products
static __device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[4j + 2h + c] is row 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c
// of a warpgroup's 64 x 128 block: round once to bfloat16 and store
static __device__ __forceinline__ void store_block(
    const float (&d)[64], __nv_bfloat16* __restrict__ out, int m, int f,
    int row0, int col0) {
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row0 + warp * 16 + lane / 4 + 8 * h;
        if (r >= m) continue;
        __nv_bfloat16* orow = out + (int64_t)r * f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = col0 + 8 * j + 2 * (lane % 4);
            if (c < f)  // f is a multiple of 8: c + 1 < f too
                *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                    __floats2bfloat162_rn(d[4 * j + 2 * h],
                                          d[4 * j + 2 * h + 1]);
        }
    }
}

// persistent: block b takes output tiles b, b + gridDim.x, ... (row-major
// over the tile grid); the ring's stage counter runs on across tiles, so
// the producer loads the next tile while the consumers store this one
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw,
                  __nv_bfloat16* __restrict__ out, int m, int f,
                  int ktiles, int tiles_n, int tiles) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);  // one arrive per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // the producer: one thread keeps the ring full
        if (threadIdx.x == 0) {
            int it = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int row0 = (tile / tiles_n) * WG_BM;
                const int col0 = (tile % tiles_n) * WG_BN;
                for (int kt = 0; kt < ktiles; ++kt, ++it) {
                    const int s = it % WG_STAGES;
                    mbar_wait(&empty[s], ((it / WG_STAGES) & 1) ^ 1);
                    uint8_t* a = ring + s * WG_STAGE_BYTES;
                    uint8_t* b = a + WG_A_BYTES;
                    mbar_expect_tx(&full[s], WG_STAGE_BYTES);
                    tma_load(a, &tmx, kt * WG_BK, row0, &full[s]);
                    tma_load(b, &tmw, col0, kt * WG_BK, &full[s]);
                    tma_load(b + WG_B_BOX, &tmw, col0 + 64, kt * WG_BK,
                             &full[s]);
                }
            }
        }
    } else {
        // a consumer: rows (wg - 1) * 64 .. + 63 of each tile
        const int half = wg - 1;
        const bool lead = (threadIdx.x & 31) == 0;
        float d[64];
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
            for (int i = 0; i < 64; ++i) d[i] = 0.f;
            for (int kt = 0; kt < ktiles; ++kt, ++it) {
                const int s = it % WG_STAGES;
                mbar_wait(&full[s], (it / WG_STAGES) & 1);
                const uint8_t* a =
                    ring + s * WG_STAGE_BYTES + half * 64 * 128;
                const uint8_t* b = ring + s * WG_STAGE_BYTES + WG_A_BYTES;
                fence_acc(d);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                for (int kk = 0; kk < WG_BK / 16; ++kk) {
                    // x: K-major, 128-byte rows, 8-row groups 1024 bytes
                    // apart; the next 16 values of K are 32 bytes along the
                    // row. w: MN-major, 16 rows of K per step (2048 bytes);
                    // the two 64-column boxes lie 8 KiB apart (the leading
                    // offset)
                    wgmma_m64n128k16(
                        d, desc128(a + kk * 32, 16, 1024),
                        desc128(b + kk * 16 * 128, WG_B_BOX, 1024));
                }
                asm volatile("wgmma.commit_group.sync.aligned;\n" :::
                                 "memory");
                // keep this stage's products in flight; the previous
                // stage's are done, so its buffers go back to the producer
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" :::
                                 "memory");
                fence_acc(d);
                __syncwarp();
                if (kt > 0 && lead)
                    mbar_arrive(&empty[(it - 1) % WG_STAGES]);
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_acc(d);
            __syncwarp();
            if (ktiles > 0 && lead) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
            store_block(d, out, m, f, (tile / tiles_n) * WG_BM + half * 64,
                        (tile % tiles_n) * WG_BN);
        }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encoder() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
        fn = (EncodeTiledFn)p;
    }
    return fn;
}

// a row-major (rows, cols) bfloat16 matrix read in (box_rows, 64) boxes
static bool encode(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                   int64_t rows, int64_t cols, uint32_t box_rows) {
    cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    cuuint32_t box[2] = {64, box_rows};
    cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims,
               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// otc_simt_matmul: float32 / int32 / bfloat16 on the CUDA cores

#define SG_BM 128
#define SG_BN 128
#define SG_BK 16
#define SG_PAD 4  // A's transposed rows: 132 words, 16-byte aligned
#define SG_THREADS 256

// four consecutive values of a row, one vector load
template <typename T> struct alignas(4 * sizeof(T)) Quad {
    T v[4];
};

// four of the accumulator type, one 16-byte shared-memory access
template <typename A> struct alignas(16) Acc4 {
    A v[4];
};

// values [c, c + 4) of row r of a row-major matrix with row stride ld,
// zeros outside rows < nr and columns < nc. VEC: the row start and c are
// 4-aligned and nc is a multiple of 4, so a quad is wholly in or out.
template <typename T, bool VEC>
__device__ __forceinline__ void load_quad(const T* __restrict__ p,
                                          int64_t ld, int64_t nr,
                                          int64_t nc, int64_t r, int64_t c,
                                          typename Acc<T>::type (&q)[4]) {
    typedef typename Acc<T>::type A;
    if (VEC) {
        if (r < nr && c < nc) {
            Quad<T> x = *reinterpret_cast<const Quad<T>*>(p + r * ld + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) q[e] = Acc<T>::in(x.v[e]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) q[e] = A(0);
        }
        return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
        q[e] = (r < nr && c + e < nc) ? Acc<T>::in(p[r * ld + c + e]) : A(0);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(SG_THREADS, 2)
simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, typename Acc<T>::type* __restrict__ ws,
            int64_t m, int64_t d, int64_t f, int64_t kchunk) {
    typedef typename Acc<T>::type A;
    // A's tile transposed (k-major) so that a thread's 4 rows are one
    // vector; B's tile as it lies. Two of each: the double buffer.
    __shared__ __align__(16) A xs[2][SG_BK][SG_BM + SG_PAD];
    __shared__ __align__(16) A wsm[2][SG_BK][SG_BN];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int64_t row0 = (int64_t)blockIdx.y * SG_BM;
    const int64_t col0 = (int64_t)blockIdx.x * SG_BN;
    const int64_t kbeg = (int64_t)blockIdx.z * kchunk;
    const int64_t kend = kbeg + kchunk < d ? kbeg + kchunk : d;
    const int ntiles = kend > kbeg ? (int)((kend - kbeg + SG_BK - 1) / SG_BK)
                                   : 0;
    A acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = A(0);

    // this thread's two quads of each tile: x row tid/4 (+64), values
    // 4*(tid%4) of the stage's 16; w row tid/32 (+8), columns 4*(tid%32)
    A qx[2][4], qw[2][4];
    auto load = [&](int t) {
        const int64_t k0 = kbeg + (int64_t)t * SG_BK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            load_quad<T, VEC>(x, d, m, kend, row0 + tid / 4 + 64 * h,
                              k0 + 4 * (tid % 4), qx[h]);
            load_quad<T, VEC>(w, f, kend, f, k0 + tid / 32 + 8 * h,
                              col0 + 4 * (tid % 32), qw[h]);
        }
    };
    auto store = [&](int buf) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                xs[buf][4 * (tid % 4) + e][tid / 4 + 64 * h] = qx[h][e];
            Acc4<A> v;
#pragma unroll
            for (int e = 0; e < 4; ++e) v.v[e] = qw[h][e];
            *reinterpret_cast<Acc4<A>*>(
                &wsm[buf][tid / 32 + 8 * h][4 * (tid % 32)]) = v;
        }
    };

    if (ntiles > 0) {
        load(0);
        store(0);
    }
    __syncthreads();
    for (int t = 0; t < ntiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < ntiles) load(t + 1);  // in flight during the FMAs
#pragma unroll
        for (int kk = 0; kk < SG_BK; ++kk) {
            A a[8], b[8];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                Acc4<A> va = *reinterpret_cast<const Acc4<A>*>(
                    &xs[buf][kk][4 * ty + 64 * h]);
                Acc4<A> vb = *reinterpret_cast<const Acc4<A>*>(
                    &wsm[buf][kk][4 * tx + 64 * h]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    a[4 * h + e] = va.v[e];
                    b[4 * h + e] = vb.v[e];
                }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = Acc<T>::fma(a[i], b[j], acc[i][j]);
        }
        if (t + 1 < ntiles) store(buf ^ 1);
        __syncthreads();
    }

    // rows 4*ty + i (+64), columns 4*tx + j (+64); a split writes its
    // partial sums to its slice of the scratch buffer
    A* part = ws != nullptr ? ws + (int64_t)blockIdx.z * m * f : nullptr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int64_t r = row0 + 4 * ty + (i % 4) + 64 * (i / 4);
        if (r >= m) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int64_t c = col0 + 4 * tx + 64 * h;
            if (part != nullptr) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (c + e < f) part[r * f + c + e] = acc[i][4 * h + e];
            } else if (VEC && c < f) {
                Quad<T> v;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v.v[e] = Acc<T>::out(acc[i][4 * h + e]);
                *reinterpret_cast<Quad<T>*>(out + r * f + c) = v;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (c + e < f)
                        out[r * f + c + e] = Acc<T>::out(acc[i][4 * h + e]);
            }
        }
    }
}

// the second pass of a K split: out = sum of the slices, in slice order
template <typename T>
__global__ void splitk_reduce_kernel(const typename Acc<T>::type* __restrict__ ws,
                                     T* __restrict__ out, int splits,
                                     int64_t count) {
    typedef typename Acc<T>::type A;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < count; i += stride) {
        A s = ws[i];
        for (int z = 1; z < splits; ++z) s += ws[(int64_t)z * count + i];
        out[i] = Acc<T>::out(s);
    }
}

template <typename T>
static int launch_simt(const void* x, const void* w, void* out, void* ws,
                       int64_t m, int64_t d, int64_t f, int64_t kchunk,
                       int splits, cudaStream_t s) {
    typedef typename Acc<T>::type A;
    const size_t q = 4 * sizeof(T);
    bool vec = d % 4 == 0 && f % 4 == 0 && kchunk % 4 == 0 &&
               (uintptr_t)x % q == 0 && (uintptr_t)w % q == 0 &&
               (uintptr_t)out % q == 0;
    dim3 grid((unsigned)((f + SG_BN - 1) / SG_BN),
              (unsigned)((m + SG_BM - 1) / SG_BM), (unsigned)splits);
    A* part = splits > 1 ? (A*)ws : nullptr;
    if (vec)
        simt_kernel<T, true><<<grid, SG_THREADS, 0, s>>>(
            (const T*)x, (const T*)w, (T*)out, part, m, d, f, kchunk);
    else
        simt_kernel<T, false><<<grid, SG_THREADS, 0, s>>>(
            (const T*)x, (const T*)w, (T*)out, part, m, d, f, kchunk);
    if (splits > 1) {
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        splitk_reduce_kernel<T><<<grid_for(m * f), OTC_THREADS, 0, s>>>(
            part, (T*)out, splits, m * f);
    }
    return (int)cudaGetLastError();
}

extern "C" {

int otc_wgmma_matmul(const void* x, const void* w, void* out, int64_t m,
                     int64_t d, int64_t f, int sms, void* stream) {
    if (m <= 0 || d <= 0 || f <= 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(out) || (d * 2) % 16 != 0 || (f * 2) % 16 != 0 ||
        sms < 1 || m > 0x7fffffff || f > 0x7fffffff ||
        ((m + WG_BM - 1) / WG_BM) * ((f + WG_BN - 1) / WG_BN) > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    EncodeTiledFn enc = encoder();
    if (enc == nullptr) return OTC_ERR_NO_ENCODER;
    CUtensorMap tmx, tmw;
    if (!encode(enc, &tmx, x, m, d, WG_BM) ||
        !encode(enc, &tmw, w, d, f, WG_BK))
        return OTC_ERR_TENSOR_MAP;
    // the dynamic shared memory above 48 KiB, once per device
    static bool smem_set[OTC_MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= OTC_MAX_DEVICES || !smem_set[dev]) {
        e = cudaFuncSetAttribute(wgmma_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WG_SMEM);
        if (e != cudaSuccess) return (int)e;
        if (dev >= 0 && dev < OTC_MAX_DEVICES) smem_set[dev] = true;
    }
    const int tiles_n = (int)((f + WG_BN - 1) / WG_BN);
    const int tiles = (int)((m + WG_BM - 1) / WG_BM) * tiles_n;
    wgmma_bf16_kernel<<<tiles < sms ? tiles : sms, WG_THREADS, WG_SMEM,
                        (cudaStream_t)stream>>>(
        tmx, tmw, (__nv_bfloat16*)out, (int)m, (int)f,
        (int)((d + WG_BK - 1) / WG_BK), tiles_n, tiles);
    return (int)cudaGetLastError();
}

int otc_simt_matmul(int dtype, const void* x, const void* w, void* out,
                    void* ws, int64_t m, int64_t d, int64_t f,
                    int64_t kchunk, int splits, void* stream) {
    if (m <= 0 || f <= 0) return 0;
    if (d < 0 || splits < 1 || splits > 65535 || kchunk < 1 ||
        (splits > 1 && (ws == nullptr || kchunk % SG_BK != 0 ||
                        kchunk * (splits - 1) >= d)) ||
        (f + SG_BN - 1) / SG_BN > 0x7fffffff ||
        (m + SG_BM - 1) / SG_BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
    case DT_F32:
        return launch_simt<float>(x, w, out, ws, m, d, f, kchunk, splits, s);
    case DT_BF16:
        return launch_simt<__nv_bfloat16>(x, w, out, ws, m, d, f, kchunk,
                                          splits, s);
    case DT_I32:
        return launch_simt<int32_t>(x, w, out, ws, m, d, f, kchunk, splits,
                                    s);
    default: return (int)cudaErrorInvalidValue;
    }
}

const char* otc_gemm_error_string(int code) {
    if (code == OTC_ERR_TENSOR_MAP)
        return "cuTensorMapEncodeTiled refused the operand's tensor map";
    if (code == OTC_ERR_NO_ENCODER)
        return "cuTensorMapEncodeTiled not found through "
               "cudaGetDriverEntryPoint";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
