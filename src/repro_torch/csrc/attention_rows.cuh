// Row staging shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): four elements of a row as float, rows of a
// global tensor into an fp32 shared tile, and the 3xTF32 wgmma kernels' A
// operands: their staged layout and their split fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"
#include "tma.cuh"

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

// An A operand of the 3xTF32 wgmma kernels (the forward's Q, the
// backward's Q, dO, K and V): rows of FRAG_D floats staged raw (fp32) with
// each row's d permuted so that the A fragments of four k8 steps are 8
// consecutive floats of a thread: d = 32c + 8j + 4h + t sits at 32c + 8t +
// 2j + h.  The 16-byte chunks of odd rows are swapped in pairs, so the two
// rows a quarter-warp reads fall on distinct banks.
constexpr int FRAG_D = 128;
__device__ __forceinline__ int frag_slot(int r, int d) {
    const int p = (d & ~31) | ((d & 3) << 3) | ((d & 31) >> 2);
    return r * FRAG_D + ((((p >> 2) ^ (r & 1)) << 2) | (p & 3));
}

// Rows [0, ROWS) of such a tile from the float32 global rows row_ptr gives
// (nullptr: zeros; 16-byte aligned), columns >= D zero.
template <int ROWS, int THREADS, typename RowPtr>
__device__ __forceinline__ void stage_frag_rows(float* dst, int D, RowPtr row_ptr) {
    for (int idx = threadIdx.x; idx < ROWS * FRAG_D / 4; idx += THREADS) {
        const int r = idx / (FRAG_D / 4), d = idx % (FRAG_D / 4) * 4;
        const float* src = row_ptr(r);
        const float4 v = src != nullptr && d < D ? load4(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[frag_slot(r, d)] = v.x;
        dst[frag_slot(r, d + 1)] = v.y;
        dst[frag_slot(r, d + 2)] = v.z;
        dst[frag_slot(r, d + 3)] = v.w;
    }
}

// The A fragments of two k8 steps (16 columns from 32 blk + 16 half) of
// rows r_lo and r_lo + 8 (lane (g, t) of a warp's 16 rows) of such a tile,
// split into TF32 big and small parts: [step][register].
__device__ __forceinline__ void load_frags(const float* sA, int r_lo, int t, int blk, int half,
                                           uint32_t (&big)[2][4], uint32_t (&small)[2][4]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int r = r_lo + 8 * rr;
        const float4 x = *reinterpret_cast<const float4*>(
            sA + r * FRAG_D + (((8 * blk + 2 * t + half) ^ (r & 1)) << 2));
        const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)  // step 2 half + m / 2, column t + 4 (m % 2), row g + 8rr
            hopper::split_tf32(v[m], big[m >> 1][rr + 2 * (m & 1)],
                               small[m >> 1][rr + 2 * (m & 1)]);
    }
}

}  // namespace attn
