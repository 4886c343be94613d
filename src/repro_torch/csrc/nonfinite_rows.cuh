// Non-finite rows reached through padding slots, shared by K1 and K2 (K3
// keeps one bit per padding block and element instead: lt_decode.cu).
//
// The plain versions of K1 and K2 multiply every neighbour slot by its weight,
// padding slots (weight 0) included, so a NaN or inf in a source row that a
// padding slot names turns into 0 * inf = NaN in their result.  The kernels
// skip zero-weight slots (a low-degree row reads only its real neighbours).
// To give the plain versions' result on such input they
// first mark, per source row, "a padding slot names this block and the row
// holds a non-finite value", and redo only the marked rows' padding terms.
//
// Two small launches before the main kernel, on its stream:
//   1. name_padding_kernel: named[s] = 1 for each block s a zero-weight slot
//      names (after a memset of the R flags);
//   2. mark_rows_kernel: one warp per row of the named blocks checks the row
//      for non-finite values; rows of other blocks are marked 0 unread.
// With finite input the marks cost one read of the named blocks (block 0 of
// the LT codes: their padding index is 0) and nothing else.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"

namespace nonfinite {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // rows per CTA: one warp each

__global__ void name_padding_kernel(const int32_t* __restrict__ idx, const float* __restrict__ w,
                                    int n_slots, int R, uint8_t* __restrict__ named) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_slots && w[i] == 0.f) {
        const int s = idx[i];
        if (s >= 0 && s < R) named[s] = 1;  // every writer stores the same byte
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mark_rows_kernel(const T* __restrict__ src, int bm, int cols, const uint8_t* __restrict__ named,
                 uint8_t* __restrict__ row_bad) {
    const int s = blockIdx.y;
    const int row = blockIdx.x * ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    if (row >= bm) return;  // whole warps leave together
    bool bad = false;
    if (named[s]) {
        const T* p = src + ((size_t)s * bm + row) * cols;
        for (int c = lane; c < cols; c += 32) bad |= !isfinite(tiles::to_f32(p[c]));
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) row_bad[(size_t)s * bm + row] = bad;
}

// scratch: R bytes of block flags, then R*bm row marks.  Returns the first
// error of the memset and the two launches.
template <typename T>
cudaError_t launch_marks(const T* src, int R, int bm, int cols, const int32_t* idx,
                         const float* w, int n_slots, uint8_t* scratch, cudaStream_t stream) {
    if (R == 0 || bm == 0) return cudaSuccess;
    uint8_t* named = scratch;
    cudaError_t err = cudaMemsetAsync(named, 0, (size_t)R, stream);
    if (err != cudaSuccess) return err;
    if (n_slots > 0)
        name_padding_kernel<<<(n_slots + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            idx, w, n_slots, R, named);
    mark_rows_kernel<T><<<dim3((bm + ROWS - 1) / ROWS, R), THREADS, 0, stream>>>(
        src, bm, cols, named, scratch + R);
    return cudaGetLastError();
}

// True iff a zero-weight slot of one neighbour row (idx/w, d_max slots)
// names a source block whose row `row` is marked.
__device__ __forceinline__ bool padding_reaches_nonfinite(const int32_t* __restrict__ idx,
                                                          const float* __restrict__ w, int d_max,
                                                          int R, int bm, int row,
                                                          const uint8_t* __restrict__ row_bad) {
    for (int j = 0; j < d_max; ++j) {
        const int s = idx[j];
        if (w[j] == 0.f && s >= 0 && s < R && row_bad[(size_t)s * bm + row]) return true;
    }
    return false;
}

}  // namespace nonfinite
