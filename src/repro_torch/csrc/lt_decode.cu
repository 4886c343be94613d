// One LT peeling round (masked gather + subtract + scale) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lt_decode_round_pallas`
// (src/repro/kernels/lt_decode/kernel.py, body `_kernel`).  For every entry
// s of one round of a peeling plan it computes
//
//     src[dst[s]] = (coded[cpos[s]] - sum_j w[s, j] * src[idx[s, j]]) * inv_pivot[s]
//
// in fp32 over bm-row blocks and writes straight into the source buffer, in
// its type, so no per-round copy or scatter follows (the TPU kernel returns
// the round's blocks and the caller scatters them into src).
//
// What bounds it on this card: one FMA per element read, so memory (3.35
// TB/s on an H100 SXM).  A round reads its entries' coded tiles and their
// nonzero-weight neighbour tiles and writes one tile per entry.
//
// Design.  One CTA of 256 threads owns one (column tile, row tile, entry):
// thread 0 compacts the entry's idx/w row to its nonzero-weight, in-range
// neighbours; each thread owns 16 bytes of columns in each of ROWS rows,
// starts its fp32 accumulators from the coded tile, subtracts each
// neighbour tile (ROWS independent 16-byte loads per neighbour), scales by
// inv_pivot and writes once.  Ragged columns or unaligned pointers take the
// element-wise form of the same loop.  The loop is tiles::gather_accumulate
// (block_io.cuh), which lt_encode.cu shares; K3 takes it with the coded tile
// as its start, sign -1, scale inv_pivot and plain loads.
//
// Writing in place is race-free because the kernel never reads a block it
// may write in this launch: the plan's nonzero-weight neighbours were all
// recovered in earlier rounds (or directly), and zero-weight (padding)
// slots, which carry index 0, are skipped; block 0 may be recovered in this
// very round.  The plain version multiplies padding slots too (0 * inf =
// NaN), so the launch first marks the source rows that this round's padding
// slots reach and that hold a non-finite value (nonfinite_rows.cuh), and a
// marked row subtracts 0 * src[idx] for its padding slots.  A marked block
// held a non-finite value before the round, so it was recovered earlier and
// is not written now: that read is race-free too.  Entries whose cpos or
// dst lie outside the buffers are skipped.
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"
#include "nonfinite_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
lt_decode_round_kernel(const T* __restrict__ coded, T* src, const int32_t* __restrict__ cpos,
                       const int32_t* __restrict__ dst, const int32_t* __restrict__ idx,
                       const float* __restrict__ w, const float* __restrict__ inv_pivot,
                       const uint8_t* __restrict__ row_bad, int R, int n_rx, int bm, int cols,
                       int d_max) {
    constexpr int VEC = 16 / sizeof(T);
    extern __shared__ int dyn[];
    int* s_src = dyn;
    float* s_w = reinterpret_cast<float*>(dyn + d_max);
    __shared__ int s_nnz;
    __shared__ uint8_t s_bad[ROWS];

    const int e = blockIdx.z, row0 = blockIdx.y * ROWS;
    const int c0 = (blockIdx.x * THREADS + threadIdx.x) * VEC;
    const int cp = cpos[e], ds = dst[e];
    if (cp < 0 || cp >= n_rx || ds < 0 || ds >= R) return;  // uniform over the CTA
    const int32_t* idx_e = idx + (size_t)e * d_max;
    const float* w_e = w + (size_t)e * d_max;
    if (threadIdx.x >= 32 && threadIdx.x < 32 + ROWS) {  // read after the compaction's sync
        const int r = threadIdx.x - 32, row = row0 + r;
        s_bad[r] = row < bm &&
                   nonfinite::padding_reaches_nonfinite(idx_e, w_e, d_max, R, bm, row, row_bad);
    }
    const int nnz = tiles::compact_neighbours(idx_e, w_e, d_max, R, s_src, s_w, &s_nnz);
    if (c0 >= cols) return;
    tiles::gather_accumulate<T, ROWS, VECTOR, false>(coded + (size_t)cp * bm * cols, src,
                                                     src + (size_t)ds * bm * cols, s_src, s_w,
                                                     nnz, s_bad, idx_e, w_e, d_max, R, -1.f,
                                                     inv_pivot[e], bm, row0, cols, c0);
}

template <typename T>
int launch(const void* coded, void* src, const void* cpos, const void* dst, const void* idx,
           const void* w, const void* inv_pivot, void* scratch, int R, int n_rx, int bm, int cols,
           int S, int d_max, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(T);
    T* srct = static_cast<T*>(src);
    const int32_t* idx32 = static_cast<const int32_t*>(idx);
    const float* wf = static_cast<const float*>(w);
    uint8_t* marks = static_cast<uint8_t*>(scratch);
    cudaError_t err = nonfinite::launch_marks<T>(srct, R, bm, cols, idx32, wf, S * d_max, marks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((cols + THREADS * VEC - 1) / (THREADS * VEC), (bm + ROWS - 1) / ROWS, S);
    const size_t smem = 2 * sizeof(int) * (size_t)d_max;
    const bool vector = cols % VEC == 0 && reinterpret_cast<uintptr_t>(coded) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const T* codedt = static_cast<const T*>(coded);
    const int32_t* cpos32 = static_cast<const int32_t*>(cpos);
    const int32_t* dst32 = static_cast<const int32_t*>(dst);
    const float* ipf = static_cast<const float*>(inv_pivot);
    if (vector)
        lt_decode_round_kernel<T, true><<<grid, THREADS, smem, s>>>(
            codedt, srct, cpos32, dst32, idx32, wf, ipf, marks + R, R, n_rx, bm, cols, d_max);
    else
        lt_decode_round_kernel<T, false><<<grid, THREADS, smem, s>>>(
            codedt, srct, cpos32, dst32, idx32, wf, ipf, marks + R, R, n_rx, bm, cols, d_max);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One peeling round over S entries: src (R*bm, cols) is updated in place from
// coded (n_rx*bm, cols), both of one type (dtype 0: float32, 1: bfloat16);
// cpos, dst (S,) int32; idx (S, d_max) int32; w (S, d_max) float32;
// inv_pivot (S,) float32; scratch R + R*bm bytes for the non-finite row
// marks.  Launches on `stream` and returns the first CUDA error.
int lt_decode_round_launch(const void* coded, void* src, const void* cpos, const void* dst,
                           const void* idx, const void* w, const void* inv_pivot, void* scratch,
                           int R, int n_rx, int bm, int cols, int S, int d_max, int dtype,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(coded, src, cpos, dst, idx, w, inv_pivot, scratch, R, n_rx,
                                     bm, cols, S, d_max, s);
    return launch<float>(coded, src, cpos, dst, idx, w, inv_pivot, scratch, R, n_rx, bm, cols, S,
                         d_max, s);
}

const char* lt_decode_round_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
