// Element conversions, neighbour compaction and 16-byte row pieces, shared
// by the LT kernels (coded_matmul.cu, lt_encode.cu, lt_decode.cu), and the
// gather-accumulate body of lt_encode.cu and lt_decode.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// Thread 0 compacts one neighbour row (idx/w, d_max slots) to its
// nonzero-weight entries whose index lies in [0, R): zero weights are the
// padding of low-degree rows, so a systematic row keeps one neighbour.
// Returns the count to every thread, after a __syncthreads.
__device__ __forceinline__ int compact_neighbours(const int32_t* __restrict__ idx,
                                                  const float* __restrict__ w, int d_max, int R,
                                                  int* s_src, float* s_w, int* s_nnz) {
    if (threadIdx.x == 0) {
        int cnt = 0;
        for (int j = 0; j < d_max; ++j) {
            const float wj = w[j];
            const int src = idx[j];
            if (wj != 0.f && src >= 0 && src < R) {
                s_src[cnt] = src;
                s_w[cnt] = wj;
                ++cnt;
            }
        }
        *s_nnz = cnt;
    }
    __syncthreads();
    return *s_nnz;
}

// VEC consecutive elements (16 bytes, 16-byte aligned) at p, as float.
// READ_ONLY loads take the read-only data path (__ldg); lt_decode uses plain
// loads, as other CTAs of its launch write the buffer it reads.
template <typename T, int VEC, bool READ_ONLY = false>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const T* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 raw = READ_ONLY ? __ldg(q) : *q;
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
}

// The same VEC elements one at a time, 0 (never read) from `left` on.
template <typename T, int VEC>
__device__ __forceinline__ void load_edge(float (&v)[VEC], const T* p, int left) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = i < left ? to_f32(p[i]) : 0.f;
}

// Write VEC values at p in T: one 16-byte store when `vector` (a streaming
// store, st.global.cs, when STREAM: the output is not read again), else
// element by element up to `left`.
template <typename T, int VEC, bool STREAM = false>
__device__ __forceinline__ void store_row_piece(T* p, const float (&v)[VEC], bool vector,
                                                int left) {
    if (vector) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
        if (STREAM) __stcs(reinterpret_cast<uint4*>(p), raw);
        else *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            if (i < left) p[i] = from_f32<T>(v[i]);
    }
}

// The body K2 and K3 share.  Each thread owns VEC consecutive columns from
// c0 (16 bytes) in each of the ROWS rows from row0 of a bm-row block:
//
//     out[row] = (init[row] + sign * sum_j s_w[j] * x[s_src[j]][row]) * scale
//
// in fp32, with init a block's tile or zero (init == nullptr).  The nnz
// compacted neighbours give ROWS independent loads each.  In a row marked in
// s_bad it also adds sign * 0 * x[idx[j]][row] for the row's padding slots
// (zero weight, index in [0, R)), as the plain versions do (0 * inf = NaN).
// x, init and out point at block 0 of their buffers (row stride cols).
// VECTOR: 16-byte loads and stores (cols a multiple of VEC, 16-byte aligned
// pointers), else single elements with the ragged edge masked.  READ_ONLY:
// x is loaded through the read-only path, which only a launch that does not
// write x may take.  STREAM: out is written with streaming stores.
template <typename T, int ROWS, bool VECTOR, bool READ_ONLY, bool STREAM = false>
__device__ __forceinline__ void gather_accumulate(
    const T* init, const T* x, T* out, const int* s_src, const float* s_w, int nnz,
    const uint8_t* s_bad, const int32_t* __restrict__ idx, const float* __restrict__ w,
    int d_max, int R, float sign, float scale, int bm, int row0, int cols, int c0) {
    constexpr int VEC = 16 / sizeof(T);
    const int left = cols - c0;
    float acc[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (init == nullptr || row0 + r >= bm) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
        } else {
            const T* p = init + (size_t)(row0 + r) * cols + c0;
            if (VECTOR) load_vec<T, VEC>(acc[r], p);
            else load_edge<T, VEC>(acc[r], p, left);
        }
    }
    for (int j = 0; j < nnz; ++j) {
        const float wj = sign * s_w[j];
        const T* base = x + ((size_t)s_src[j] * bm + row0) * cols + c0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (row0 + r >= bm) break;
            float v[VEC];
            if (VECTOR) load_vec<T, VEC, READ_ONLY>(v, base + (size_t)r * cols);
            else load_edge<T, VEC>(v, base + (size_t)r * cols, left);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(wj, v[i], acc[r][i]);
        }
    }
    const float zero = sign * 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r;
        if (row >= bm) break;
        if (s_bad[r]) {  // rare: the padding slots' 0 * x terms of this row
            for (int j = 0; j < d_max; ++j) {
                const int s = idx[j];
                if (w[j] != 0.f || s < 0 || s >= R) continue;
                float v[VEC];
                load_edge<T, VEC>(v, x + ((size_t)s * bm + row) * cols + c0, left);
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[r][i] += zero * v[i];
            }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] *= scale;
        store_row_piece<T, VEC, STREAM>(out + (size_t)row * cols + c0, acc[r], VECTOR, left);
    }
}

}  // namespace tiles
