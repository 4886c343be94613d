// Fused LT-encode + block matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `coded_matmul_pallas`
// (src/repro/kernels/coded_matmul/kernel.py, body `_kernel`).  A is R
// row-blocks of bm rows; for every coded block b of C it computes
//
//     V[b] = (sum_j w[b, j] * A[idx[b, j]]) @ X        fp32 accumulation
//
// and writes V in the type of X.  As on the TPU, the encoded A tile is
// built on chip and never written to device memory.
//
// What bounds it on this card: at the main-path shape (C = 40, bm = 256,
// k = n = 4096) the product is 2*C*bm*k*n = 3.4e11 operations against about
// 0.37 GB that must move, so it is bound by operations.  This version runs
// them as fp32 FMA on the CUDA cores (67 TFLOP/s peak on an H100 SXM), which
// keeps fp32 within the reference's 1e-5 tolerance.  It uses no tensor cores
// yet: wgmma, TMA and TF32/bf16 variants are later work.
//
// Design.  One CTA (256 threads, two per SM) owns one (column tile, row
// tile of a coded block, coded block).  It first compacts its own idx/w row
// to the nonzero-weight neighbours (zero weights are the padding of
// low-degree rows, so a systematic block reads one A tile and a parity d).
// It then walks k in tiles of BK with two shared-memory buffers for the
// encoded-A and X tiles: threads multiply the current pair (8x8 outputs per
// thread, fp32 FMA, operands read as float4) while the next tile is on its
// way, then encode the next A tile (sum the neighbour tiles in fp32) into
// the other buffer.  Ragged rows (bm not a multiple of BM), k and n are
// masked here, so the caller pads nothing.  Neighbour indices outside
// [0, R) are skipped, never read.
//
// The encode is what a plain GEMM does not have, and its dependent loads
// are what bound a parity block: summing d neighbour tiles straight from
// device memory costs d round trips per k tile.  So for float32 (the main
// path) the next tile's neighbour tiles and X tile are copied into shared
// memory with cp.async (16 bytes a copy where k and n are multiples of 4:
// the copies, not the bytes, are what a parity block runs short of), issued
// before the current tile's product and waited for after it; the encode
// then reads shared memory only.  bfloat16
// inputs (no 2-byte cp.async) take the same design with the next tile's X
// and first neighbour prefetched into registers and the other neighbours
// loaded after the product.
//
// Non-finite input.  The plain version multiplies padding slots too, so a
// NaN or inf in a source row that a coded block reaches only through a
// padding slot (weight 0) makes that row of its encoded tile NaN, and then
// the whole product row.  Compaction skips those slots, so the launch first
// marks the source rows that padding slots reach and that hold a non-finite
// value (nonfinite_rows.cuh); the epilogue writes NaN to the output rows
// whose padding slots reach a marked row.  With finite input the marks cost
// one read of the blocks padding slots name (block 0 for the LT codes).
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"
#include "nonfinite_rows.cuh"

namespace {

using tiles::from_f32;
using tiles::to_f32;

constexpr int BM = 128;       // rows of a coded block per CTA
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 8;         // reduction depth per tile
constexpr int THREADS = 256;
constexpr int A_LD = BM + 4;  // padded row of the k-major encoded tile: conflict-free stores
constexpr int STAGE_D = 16;   // neighbour tiles staged per k tile (float32 kernel)
constexpr int RAW_TILE = BM * BK;  // floats in one staged neighbour tile

// 4-byte asynchronous copy global -> shared; zero-fills when !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}
// 16-byte asynchronous copy of `bytes` (0..16) bytes, zero-filling the
// rest; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ int clamp_bytes(int elems) {  // 4-byte elements left, as 0..16 bytes
    return elems <= 0 ? 0 : (elems >= 4 ? 16 : 4 * elems);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread roles.  Loader: A row tid/2, k columns (tid%2)*4..+3; X row
// tid/32, columns (tid%32)*4..+3.  Product: rows ty*4+i and 64+ty*4+i,
// columns tx*4+j and 64+tx*4+j, with ty = tid/16, tx = tid%16.
struct Roles {
    int a_row, a_col, x_row, x_col, ty, tx;
    __device__ explicit Roles(int tid)
        : a_row(tid >> 1), a_col((tid & 1) * 4), x_row(tid >> 5), x_col((tid & 31) * 4),
          ty(tid >> 4), tx(tid & 15) {}
};

// Four consecutive k values of one A row, zero where masked.
template <typename T>
__device__ __forceinline__ void load_a4(float (&v)[4], const T* __restrict__ a, int src,
                                        int bm, int k, int row, int col) {
    const T* p = a + ((size_t)src * bm + row) * k + col;
    const bool row_ok = row < bm;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (row_ok && col + i < k) ? to_f32(p[i]) : 0.f;
}

// acc += As_tile @ Xs_tile for this thread's 8x8 outputs.
__device__ __forceinline__ void product_tile(float (&acc)[8][8], float (*As)[A_LD],
                                             float (*Xs)[BN], const Roles& ro) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ro.ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ro.ty * 4]);
        const float4 x0 = *reinterpret_cast<const float4*>(&Xs[kk][ro.tx * 4]);
        const float4 x1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ro.tx * 4]);
        const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float rx[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rx[j], acc[i][j]);
    }
}

// s_bad[r] for the CTA's rows: a padding slot of block b reaches a marked
// (non-finite) source row.  Read only after a later __syncthreads.
__device__ __forceinline__ void mark_bad_rows(uint8_t* s_bad, const int32_t* __restrict__ idx,
                                              const float* __restrict__ w,
                                              const uint8_t* __restrict__ row_bad, int b,
                                              int d_max, int R, int bm, int row0) {
    const int row = row0 + threadIdx.x;
    if (threadIdx.x < BM)
        s_bad[threadIdx.x] = row < bm && nonfinite::padding_reaches_nonfinite(
                                             idx + (size_t)b * d_max, w + (size_t)b * d_max,
                                             d_max, R, bm, row, row_bad);
}

// Write the 8x8 outputs once, in the output type; rows marked in s_bad are
// NaN, as 0 * inf in an encoded element makes the plain version's row.
template <typename T>
__device__ __forceinline__ void write_out(T* __restrict__ out, const float (&acc)[8][8],
                                          const Roles& ro, const uint8_t* s_bad, int b, int row0,
                                          int col0, int bm, int n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = i < 4 ? ro.ty * 4 + i : 64 + ro.ty * 4 + i - 4;
        const int row = row0 + r;
        if (row >= bm) continue;
        const bool bad = s_bad[r];
        T* out_row = out + ((size_t)b * bm + row) * n;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = col0 + (j < 4 ? ro.tx * 4 + j : 64 + ro.tx * 4 + j - 4);
            if (col < n) out_row[col] = from_f32<T>(bad ? __int_as_float(0x7fc00000) : acc[i][j]);
        }
    }
}

// float32: neighbour and X tiles staged by cp.async.  Dynamic shared
// memory: `stage` raw neighbour tiles, then d_max ids and d_max weights.
__global__ void __launch_bounds__(THREADS, 2)
coded_matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ x,
                        const int32_t* __restrict__ idx, const float* __restrict__ w,
                        const uint8_t* __restrict__ row_bad, float* __restrict__ out, int R,
                        int bm, int k, int n, int d_max, int stage, int vec) {
    __shared__ __align__(16) float As[2][BK][A_LD];
    __shared__ __align__(16) float Xs[2][BK][BN];
    __shared__ int s_nnz;
    __shared__ uint8_t s_bad[BM];
    extern __shared__ __align__(16) float dyn_f32[];
    float* raw = dyn_f32;  // [stage][BM][BK]
    int* s_src = reinterpret_cast<int*>(raw + (size_t)stage * RAW_TILE);
    float* s_w = reinterpret_cast<float*>(s_src + d_max);

    const int b = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const Roles ro(threadIdx.x);
    const int nnz = tiles::compact_neighbours(idx + (size_t)b * d_max, w + (size_t)b * d_max,
                                              d_max, R, s_src, s_w, &s_nnz);
    mark_bad_rows(s_bad, idx, w, row_bad, b, d_max, R, bm, row0);
    const int staged = min(nnz, stage);
    const int a_grow = row0 + ro.a_row;

    auto issue = [&](int k0, int buf) {  // cp.async the tile at k0
        const int kr = k0 + ro.x_row;
        if (vec) {  // k, n multiples of 4 and a, x 16-byte aligned: one copy per row piece
            const int a_bytes = a_grow < bm ? clamp_bytes(k - k0 - ro.a_col) : 0;
            for (int j = 0; j < staged; ++j) {
                const float* src = a + ((size_t)s_src[j] * bm + a_grow) * k + k0 + ro.a_col;
                cp_async16(raw + j * RAW_TILE + ro.a_row * BK + ro.a_col, a_bytes ? src : a,
                           a_bytes);
            }
            const int c = col0 + ro.x_col;
            const int x_bytes = kr < k ? clamp_bytes(n - c) : 0;
            cp_async16(&Xs[buf][ro.x_row][ro.x_col], x_bytes ? x + (size_t)kr * n + c : x,
                       x_bytes);
        } else {
            for (int j = 0; j < staged; ++j) {
                const float* src = a + ((size_t)s_src[j] * bm + a_grow) * k + k0 + ro.a_col;
                float* dst = raw + j * RAW_TILE + ro.a_row * BK + ro.a_col;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const bool ok = a_grow < bm && k0 + ro.a_col + i < k;
                    cp_async4(dst + i, ok ? src + i : a, ok);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = col0 + ro.x_col + i;
                const bool ok = kr < k && c < n;
                cp_async4(&Xs[buf][ro.x_row][ro.x_col + i], ok ? x + (size_t)kr * n + c : x, ok);
            }
        }
        cp_async_commit();
    };
    auto encode = [&](int k0, int buf) {  // after the copies landed
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < staged; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(raw + j * RAW_TILE + ro.a_row * BK + ro.a_col);
            const float wj = s_w[j];
            s[0] += wj * v.x;
            s[1] += wj * v.y;
            s[2] += wj * v.z;
            s[3] += wj * v.w;
        }
        for (int j = staged; j < nnz; ++j) {  // beyond the stage: straight from memory
            float v[4];
            load_a4(v, a, s_src[j], bm, k, a_grow, k0 + ro.a_col);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i] += s_w[j] * v[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) As[buf][ro.a_col + i][ro.a_row] = s[i];
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    issue(0, 0);
    cp_async_wait_all();
    __syncthreads();
    encode(0, 0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < k; k0 += BK) {
        const bool more = k0 + BK < k;
        if (more) issue(k0 + BK, buf ^ 1);
        product_tile(acc, As[buf], Xs[buf], ro);
        if (more) {
            cp_async_wait_all();
            __syncthreads();  // the staged tiles are visible to every thread
            encode(k0 + BK, buf ^ 1);
        }
        __syncthreads();
        buf ^= 1;
    }
    write_out(out, acc, ro, s_bad, b, row0, col0, bm, n);
}

// bfloat16 (and any other input type): the next tile's X and first
// neighbour are prefetched into registers before the product; the other
// neighbours are loaded and summed after it.  Dynamic shared memory: d_max
// ids, then d_max weights.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
coded_matmul_regs_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         const int32_t* __restrict__ idx, const float* __restrict__ w,
                         const uint8_t* __restrict__ row_bad, T* __restrict__ out, int R, int bm,
                         int k, int n, int d_max) {
    __shared__ __align__(16) float As[2][BK][A_LD];
    __shared__ __align__(16) float Xs[2][BK][BN];
    __shared__ int s_nnz;
    __shared__ uint8_t s_bad[BM];
    extern __shared__ int dyn_i32[];
    int* s_src = dyn_i32;
    float* s_w = reinterpret_cast<float*>(dyn_i32 + d_max);

    const int b = blockIdx.z, row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const Roles ro(threadIdx.x);
    const int nnz = tiles::compact_neighbours(idx + (size_t)b * d_max, w + (size_t)b * d_max,
                                              d_max, R, s_src, s_w, &s_nnz);
    mark_bad_rows(s_bad, idx, w, row_bad, b, d_max, R, bm, row0);
    const int a_grow = row0 + ro.a_row;

    float a_first[4], x_next[4];
    auto prefetch = [&](int k0) {
        if (nnz > 0) load_a4(a_first, a, s_src[0], bm, k, a_grow, k0 + ro.a_col);
        const int kr = k0 + ro.x_row;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int c = col0 + ro.x_col + i;
            x_next[i] = (kr < k && c < n) ? to_f32(x[(size_t)kr * n + c]) : 0.f;
        }
    };
    auto encode_store = [&](int k0, int buf) {
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = nnz > 0 ? s_w[0] * a_first[i] : 0.f;
        int j = 1;
        for (; j + 1 < nnz; j += 2) {  // two neighbours' loads in flight at once
            float v0[4], v1[4];
            load_a4(v0, a, s_src[j], bm, k, a_grow, k0 + ro.a_col);
            load_a4(v1, a, s_src[j + 1], bm, k, a_grow, k0 + ro.a_col);
            const float w0 = s_w[j], w1 = s_w[j + 1];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                s[i] += w0 * v0[i];
                s[i] += w1 * v1[i];
            }
        }
        if (j < nnz) {
            float v0[4];
            load_a4(v0, a, s_src[j], bm, k, a_grow, k0 + ro.a_col);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i] += s_w[j] * v0[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) As[buf][ro.a_col + i][ro.a_row] = s[i];
        *reinterpret_cast<float4*>(&Xs[buf][ro.x_row][ro.x_col]) =
            make_float4(x_next[0], x_next[1], x_next[2], x_next[3]);
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    prefetch(0);
    encode_store(0, 0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < k; k0 += BK) {
        const bool more = k0 + BK < k;
        if (more) prefetch(k0 + BK);
        product_tile(acc, As[buf], Xs[buf], ro);
        if (more) encode_store(k0 + BK, buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }
    write_out(out, acc, ro, s_bad, b, row0, col0, bm, n);
}

}  // namespace

extern "C" {

// out (C*bm, n) = coded products of a (R*bm, k) and x (k, n), both of one
// type (dtype 0: float32, 1: bfloat16); idx (C, d_max) int32, w (C, d_max)
// float32; scratch R + R*bm bytes for the non-finite row marks.  Launches the
// marks and the product on `stream` and returns the first CUDA error.
int coded_matmul_launch(const void* a, const void* x, const void* idx, const void* w,
                        void* out, void* scratch, int R, int bm, int k, int n, int C, int d_max,
                        int dtype, void* stream) {
    const dim3 grid((n + BN - 1) / BN, (bm + BM - 1) / BM, C);
    const size_t nbr_bytes = 2 * sizeof(int) * (size_t)d_max;  // compacted neighbours
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint8_t* marks = static_cast<uint8_t*>(scratch);
    const uint8_t* row_bad = marks + R;
    const int32_t* idx32 = static_cast<const int32_t*>(idx);
    const float* wf = static_cast<const float*>(w);
    if (dtype == 1) {
        cudaError_t err = nonfinite::launch_marks(static_cast<const __nv_bfloat16*>(a), R, bm, k,
                                                  idx32, wf, C * d_max, marks, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        coded_matmul_regs_kernel<__nv_bfloat16><<<grid, THREADS, nbr_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(x), idx32,
            wf, row_bad, static_cast<__nv_bfloat16*>(out), R, bm, k, n, d_max);
    } else {
        cudaError_t err = nonfinite::launch_marks(static_cast<const float*>(a), R, bm, k, idx32,
                                                  wf, C * d_max, marks, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int stage = d_max < STAGE_D ? d_max : STAGE_D;
        const int vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0;
        const size_t smem = sizeof(float) * (size_t)stage * RAW_TILE + nbr_bytes;
        err = cudaFuncSetAttribute(coded_matmul_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        coded_matmul_f32_kernel<<<grid, THREADS, smem, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(x), idx32, wf, row_bad,
            static_cast<float*>(out), R, bm, k, n, d_max, stage, vec);
    }
    return static_cast<int>(cudaGetLastError());
}

const char* coded_matmul_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
