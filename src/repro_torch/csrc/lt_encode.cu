// Standalone LT encode (gather + weighted accumulate) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lt_encode_pallas`
// (src/repro/kernels/lt_encode/kernel.py, body `_kernel`).  A is R
// row-blocks of bm rows; for every coded block b of C it computes
//
//     coded[b] = sum_j w[b, j] * A[idx[b, j]]        fp32 accumulation
//
// and writes it once in A's type.
//
// What bounds it on this card: it does one FMA per element read, so it is
// bound by memory (3.35 TB/s on an H100 SXM).  The least traffic is A read
// once and the output written once: 0.240 ms and 0.481 ms at the rateless
// path's two shapes (R 64, bm 256, cols 4096 and R 256, bm 64, cols 8192,
// C = 2R).  A coded block of degree d reads d source tiles, so the reads
// come to about A (1 + d K / R), five times A or more: they must come from
// L2, not from device memory.
//
// Design.  One CTA of 256 threads owns one (coded block, ROWS = 2 rows,
// 1024 columns of float32 / 2048 of bfloat16).  The coded block is the
// fastest axis of the grid, so the CTAs in flight (up to eight an SM) are
// every coded block of a few (row, column) slabs: a slab's source tiles,
// R x 2 rows x 4 KB (512 KB at the first shape, 2 MB at the second), leave
// device memory once and every coded block that names them reads them from
// the 50 MB L2.  (With the column tiles fastest, the CTAs in flight would
// cover a few whole coded blocks, and each neighbour tile would come from
// device memory again.)  The neighbour reads, about 5x A, then come from
// L2: chip_smoke.py's [k2-rateless-shape] prints their rate with the
// output's (gather_tbps) beside a copy's (copy_tbps).  Two rows a CTA ran
// fastest of the counts tried on the card, 1 to 16 (one row keeps too few
// loads in flight a thread).  A slab of all R source blocks held in
// shared memory, one CTA an SM walking its rows, ran slower and was not
// kept; at R = 256 a slab row holds only 256 bytes of each source block.
//
// Thread 0 compacts the block's idx/w row to its nonzero-weight, in-range
// neighbours in shared memory (zero weights are padding, so a systematic
// block reads one tile and a parity its degree).  Each thread owns 16 bytes
// of columns (4 float32 or 8 bfloat16) in each of the ROWS rows: for every
// neighbour it issues ROWS independent 16-byte loads and accumulates in
// fp32 registers, then writes once with streaming stores (the output is not
// read again).  Where the columns are not a multiple of the vector or a
// pointer is not 16-byte aligned, the same loop runs on single elements with
// the ragged edge masked, so the caller pads nothing (the TPU path pads
// columns to bc = 512).
//
// Non-finite input: the plain version multiplies padding slots too (0 * inf
// = NaN).  The launch first marks the source rows that padding slots reach
// and that hold a non-finite value (nonfinite_rows.cuh); in a row so marked
// the kernel adds 0 * A[idx] for each padding slot, which gives the plain
// version's NaNs element by element.
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
constexpr int ROWS = 2;  // rows of a coded block per CTA: independent loads per neighbour

// Each thread owns VEC consecutive columns from c0 (16 bytes) in each of the
// ROWS rows from row0 of a bm-row block:
//
//     out[row] = sum_j s_w[j] * a[s_src[j]][row]
//
// in fp32 over the nnz compacted neighbours, ROWS independent read-only loads
// each.  In a row marked in s_bad it also adds 0 * a[idx[j]][row] for the
// row's padding slots (zero weight, index in [0, R)), as the plain version
// does (0 * inf = NaN).  a and out point at block 0 of their buffers (row
// stride cols).  VECTOR: 16-byte loads and stores (cols a multiple of VEC,
// 16-byte aligned pointers), else single elements with the ragged edge
// masked.  The output is written with streaming stores: it is not read again.
template <typename T, bool VECTOR>
__device__ __forceinline__ void encode_rows(const T* __restrict__ a, T* out, const int* s_src,
                                            const float* s_w, int nnz, const uint8_t* s_bad,
                                            const int32_t* __restrict__ idx,
                                            const float* __restrict__ w, int d_max, int R,
                                            int bm, int row0, int cols, int c0) {
    constexpr int VEC = 16 / sizeof(T);
    const int left = cols - c0;
    float acc[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
    for (int j = 0; j < nnz; ++j) {
        const float wj = s_w[j];
        const T* base = a + ((size_t)s_src[j] * bm + row0) * cols + c0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (row0 + r >= bm) break;
            float v[VEC];
            if (VECTOR) tiles::load_vec<T, VEC, true>(v, base + (size_t)r * cols);
            else tiles::load_edge<T, VEC>(v, base + (size_t)r * cols, left);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(wj, v[i], acc[r][i]);
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r;
        if (row >= bm) break;
        if (s_bad[r]) {  // rare: the padding slots' 0 * a terms of this row
            for (int j = 0; j < d_max; ++j) {
                const int s = idx[j];
                if (w[j] != 0.f || s < 0 || s >= R) continue;
                float v[VEC];
                tiles::load_edge<T, VEC>(v, a + ((size_t)s * bm + row) * cols + c0, left);
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[r][i] += 0.f * v[i];
            }
        }
        tiles::store_row_piece<T, VEC, true>(out + (size_t)row * cols + c0, acc[r], VECTOR,
                                             left);
    }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
lt_encode_kernel(const T* __restrict__ a, const int32_t* __restrict__ idx,
                 const float* __restrict__ w, const uint8_t* __restrict__ row_bad,
                 T* __restrict__ out, int R, int bm, int cols, int d_max) {
    constexpr int VEC = 16 / sizeof(T);
    extern __shared__ int dyn[];
    int* s_src = dyn;
    float* s_w = reinterpret_cast<float*>(dyn + d_max);
    __shared__ int s_nnz;
    __shared__ uint8_t s_bad[ROWS];

    const int b = blockIdx.x, row0 = blockIdx.y * ROWS;  // coded blocks fastest
    const int c0 = (blockIdx.z * THREADS + threadIdx.x) * VEC;
    const int32_t* idx_b = idx + (size_t)b * d_max;
    const float* w_b = w + (size_t)b * d_max;
    if (threadIdx.x >= 32 && threadIdx.x < 32 + ROWS) {  // read after the compaction's sync
        const int r = threadIdx.x - 32, row = row0 + r;
        s_bad[r] = row < bm &&
                   nonfinite::padding_reaches_nonfinite(idx_b, w_b, d_max, R, bm, row, row_bad);
    }
    const int nnz = tiles::compact_neighbours(idx_b, w_b, d_max, R, s_src, s_w, &s_nnz);
    if (c0 >= cols) return;
    encode_rows<T, VECTOR>(a, out + (size_t)b * bm * cols, s_src, s_w, nnz, s_bad, idx_b, w_b,
                           d_max, R, bm, row0, cols, c0);
}

template <typename T>
int launch(const void* a, const void* idx, const void* w, void* out, void* scratch, int R,
           int bm, int cols, int C, int d_max, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(T);
    const T* at = static_cast<const T*>(a);
    const int32_t* idx32 = static_cast<const int32_t*>(idx);
    const float* wf = static_cast<const float*>(w);
    uint8_t* marks = static_cast<uint8_t*>(scratch);
    cudaError_t err = nonfinite::launch_marks(at, R, bm, cols, idx32, wf, C * d_max, marks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(C, (bm + ROWS - 1) / ROWS, (cols + THREADS * VEC - 1) / (THREADS * VEC));
    const size_t smem = 2 * sizeof(int) * (size_t)d_max;
    const bool vector = cols % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vector)
        lt_encode_kernel<T, true><<<grid, THREADS, smem, s>>>(at, idx32, wf, marks + R,
                                                              static_cast<T*>(out), R, bm, cols,
                                                              d_max);
    else
        lt_encode_kernel<T, false><<<grid, THREADS, smem, s>>>(at, idx32, wf, marks + R,
                                                               static_cast<T*>(out), R, bm,
                                                               cols, d_max);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (C*bm, cols) = LT encode of a (R*bm, cols) (dtype 0: float32, 1:
// bfloat16) with idx (C, d_max) int32 and w (C, d_max) float32; scratch R +
// R*bm bytes for the non-finite row marks.  Launches on `stream` and returns
// the first CUDA error.
int lt_encode_launch(const void* a, const void* idx, const void* w, void* out, void* scratch,
                     int R, int bm, int cols, int C, int d_max, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) return launch<__nv_bfloat16>(a, idx, w, out, scratch, R, bm, cols, C, d_max, s);
    return launch<float>(a, idx, w, out, scratch, R, bm, cols, C, d_max, s);
}

const char* lt_encode_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
