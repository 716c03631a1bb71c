// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma bodies
// (flash_attention.cu, flash_decode.cu): mbarriers, TMA tile loads, wgmma
// descriptors and fences, and the tensor maps those loads read.
//
// Build.  cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime;
// it is looked up with dlsym in the libcuda.so.1 already loaded into the
// process, so a library that includes this header links -ldl and no
// -lcuda.  _build.py hashes this header into every library's name, so an
// edit here rebuilds them all.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BOX_COLS = 64;    // one TMA box row: 64 bf16, 128 bytes, the swizzle span
constexpr uint32_t ROW_BYTES = BOX_COLS * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// returns once the phase of the given parity has completed; a wait that
// never completes (a fault in the pipeline) traps after ~10 s, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long start = 0;
    for (bool first = true;; first = false) {
        uint32_t done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (first) start = clock64();
        else if (clock64() - start > (20ll << 30)) __trap();
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// a wgmma shared-memory descriptor for a 128B-swizzled tile
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
        if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// a (D, S, BH) bf16 tensor as boxes of 64 columns x box_rows rows,
// 128B-swizzled; columns past D and rows past S read as zeros.  D x 2 bytes
// must be a multiple of 16.  The caller has made a context current (a
// runtime call such as cudaFuncSetAttribute does).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int S, int BH, int box_rows) {
    EncodeTiled fn = encode_tiled();
    if (!fn) return cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
    const cuuint32_t box[3] = {BOX_COLS, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
