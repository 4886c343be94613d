// Row staging shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): four elements of a row as float, and rows of a
// global tensor into an fp32 shared tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"

namespace attn {

// Four consecutive elements at p (16-byte aligned for float32, 8-byte for
// bfloat16), through the read-only path, as float.
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    return make_float4(tiles::to_f32(e[0]), tiles::to_f32(e[1]), tiles::to_f32(e[2]),
                       tiles::to_f32(e[3]));
}

// Rows [0, ROWS) of a (ROWS, DMAX) shared tile with row stride LD, from the
// global rows that row_ptr gives (nullptr: zeros), columns >= D zero-filled.
// VEC (D and every row a multiple of 4 elements, aligned): each thread owns
// 4 columns and issues up to 8 row loads before it stores any, so a CTA
// keeps many loads in flight (a decode step has only B * Hkv CTAs).
// Otherwise one element per thread and load.
template <typename T, int DMAX, int ROWS, int LD, int THREADS, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int D, bool vec,
                                           RowPtr row_ptr) {
    if (vec) {
        constexpr int TPR = DMAX / 4, RPI = THREADS / TPR, PASSES = ROWS / RPI;
        constexpr int UNR = PASSES < 8 ? PASSES : 8;
        static_assert(THREADS % TPR == 0 && ROWS % RPI == 0 && PASSES % UNR == 0, "tiling");
        const int r0 = threadIdx.x / TPR, c4 = threadIdx.x % TPR * 4;
#pragma unroll
        for (int p0 = 0; p0 < PASSES; p0 += UNR) {
            float4 v[UNR];
#pragma unroll
            for (int u = 0; u < UNR; ++u) {
                const T* src = row_ptr(r0 + (p0 + u) * RPI);
                v[u] = (src != nullptr && c4 < D) ? load4(src + c4)
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < UNR; ++u)
                *reinterpret_cast<float4*>(&dst[(r0 + (p0 + u) * RPI) * LD + c4]) = v[u];
        }
        return;
    }
    constexpr int TPR = DMAX < THREADS ? DMAX : THREADS;  // threads per row
    constexpr int RPI = THREADS / TPR;                    // rows per pass
    const int r0 = threadIdx.x / TPR, d0 = threadIdx.x % TPR;
#pragma unroll 4
    for (int r = r0; r < ROWS; r += RPI) {
        const T* src = row_ptr(r);
#pragma unroll
        for (int d = d0; d < DMAX; d += TPR)
            dst[r * LD + d] = (src != nullptr && d < D) ? tiles::to_f32(src[d]) : 0.f;
    }
}

}  // namespace attn
