// Element conversions, neighbour compaction and 16-byte row pieces, shared
// by the LT kernels (coded_matmul.cu, lt_encode.cu, lt_decode.cu).

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
// READ_ONLY loads take the read-only data path (__ldg), which only a launch
// that does not write the buffer may take.
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

}  // namespace tiles
