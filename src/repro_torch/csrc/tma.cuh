// Hopper's asynchronous copies and tensor-core products, shared by the
// kernels that run on them (coded_matmul.cu, flash_attention.cu,
// flash_attention_bwd.cu): mbarrier waits, TMA tile loads and their
// descriptors, 16-byte shared stores, and the TF32 wgmma instructions with
// A from registers and B from shared memory.
//
// The descriptors come from cuTensorMapEncodeTiled, which the runtime
// hands out through cudaGetDriverEntryPoint, so nothing links -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of `parity` to complete.  A wait that outlasts 10 s
// traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint64_t t0 = 0;
    for (int spin = 0;; ++spin) {
        uint32_t done;
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        uint64_t now;
        asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
        if (spin == 0) t0 = now;
        else if (now - t0 > 10000000000ull) __trap();
    }
}
// Orders this thread's earlier shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One 16-byte shared-memory store (st.shared.v4), whatever the compiler can
// prove of the pointer's alignment.
__device__ __forceinline__ void sts128(void* p, uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(smem_u32(p)), "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
// One 2D TMA tile (inner coordinate c0, row c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(smem_u32(bar))
        : "memory");
}
// One 4D TMA box at coordinates (c0 innermost, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A TMA map of a float32 tensor of `rank` dimensions (dims[0] innermost and
// contiguous; strides in bytes of dims 1.., multiples of 16), read in boxes
// of `box`; reads past the edges give zeros.
inline bool float_map(CUtensorMap* map, const void* base, cuuint32_t rank,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides,
              box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
           CUDA_SUCCESS;
}

// ---- TF32 on wgmma -------------------------------------------------------------

// v = big + small, both TF32, by truncation: big keeps v's top 10 mantissa
// bits, rest = v - big is exact, and small keeps rest's top 10; what small
// drops is below 2^-20 |v|.  One AND each, where cvt.rna took longer on the
// card, and an AND keeps inf and NaN as they are (rounding by adding half
// of the dropped bits would carry CUDA's NaN, 0x7fffffff, into -0).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
    big = __float_as_uint(v) & 0xFFFFE000u;
    const float rest = v - __uint_as_float(big);
    small = __float_as_uint(rest) & 0xFFFFE000u;
}

// Shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (8-row atoms of 1024 bytes, the tile 1024-byte aligned),
// starting `byte_off` bytes into the row (the k8 step).
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, int byte_off) {
    const uint64_t addr = smem_u32(tile) + byte_off;
    return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Registers an in-flight wgmma reads: kept (unchanged, unreused) up to here.
__device__ __forceinline__ void keep_live(uint32_t& u, uint32_t& v) {
    asm volatile("" : "+r"(u), "+r"(v) :: "memory");
}
__device__ __forceinline__ void keep_live(float& u, uint32_t& v) {
    asm volatile("" : "+f"(u), "+r"(v) :: "memory");
}
// Accumulator registers read only after the wgmma.wait_group before this:
// the compiler cannot move a read of them above it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, this thread's 64 floats) = (scale_d ? d : 0) + a (64 x 8,
// registers) . b (8 x 128, shared memory, K-major), TF32 in, fp32 sum.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc_b));
}

// The same with a 64-wide B: d (64 x 64, this thread's 32 floats), the A
// fragment's four registers given one by one.
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(scale_d), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
    wgmma_tf32_m64n64k8(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
}

// The same with a 32-wide B: d (64 x 32, this thread's 16 floats).
__device__ __forceinline__ void wgmma_tf32_m64n32k8(float (&d)[16], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                    int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %21, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(scale_d), "l"(desc_b));
}
__device__ __forceinline__ void wgmma_tf32_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
    wgmma_tf32_m64n32k8(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
}

}  // namespace hopper
