// LT peeling decode (K3) for Hopper (sm_90a): one launch walks a whole
// peeling plan.
//
// Replaces the Pallas TPU kernel `lt_decode_round_pallas`
// (src/repro/kernels/lt_decode/kernel.py, body `_kernel`), which the TPU
// calls once per round of `plan_rounds`.  For every entry s of the plan, in
// round order, it computes
//
//     src[dst[s]] = (coded[cpos[s]] - sum_j w[s, j] * src[idx[s, j]]) * inv_pivot[s]
//
// in fp32 over whole blocks (bm rows of cols elements, bm * cols contiguous
// elements) and stores in the data's type, straight into the source buffer.
//
// Why the rounds disappear on this card.  The peel is elementwise in the
// block: element x of a recovered block depends only on element x of its
// coded block and of its neighbours.  So a thread that owns one position x
// (16 bytes: 4 float32 or 8 bfloat16 elements) in every block can walk the
// plan's entries in round order by itself.  Every neighbour value it reads at
// x was either there before the launch (the direct fills) or written by that
// same thread earlier in the walk, so no barrier between rounds and no second
// launch is needed, and no thread ever touches another thread's elements: the
// launch is race-free for any schedule.  The TPU needed one pallas_call per
// level because its grid is one sequential walk over tiles.
//
// What bounds it: one FMA per element read, so memory (3.35 TB/s on an H100
// SXM).  The plan-level bound counts the inputs read once (each entry's coded
// block, and the direct-filled neighbours and padding blocks) and each
// recovered block written once; a block that the launch recovers and then
// reads again is an intermediate.  Sizing for that: one 16-byte piece a
// thread, 256 threads a CTA, so the rateless path's blocks give 1024 CTAs
// (R=64: 256 x 4096 float32) and 512 (R=256: 64 x 8192), 7.8 and 3.9 per SM
// of 132, and the coded-matmul collector's 256 x 4096 blocks 1024; an
// entry's neighbour loads are issued NB at a time before the first
// subtraction, so a thread keeps up to NB + 1 loads in flight.
//
// The schedule.  The host (kernels/lt_decode/schedule.py) builds one int32
// program per plan and copies it to the card in one piece.  Records:
//   round: [(n_pad << 2) | 2, width, pad_0 .. pad_{n_pad-1}]
//   entry: [(nnz << 2) | 1, cpos, dst, padmask, inv_pivot bits,
//           idx_0, w_0 bits, .., idx_{nnz-1}, w_{nnz-1} bits]
// (an entry lists only its nonzero-weight neighbours; width is read by the
// plain version alone).  A word 0 ends a chunk: every CTA stages the program
// in shared memory MAX_CHUNK_WORDS at a time, and no record straddles a
// chunk, so a plan of any size fits.  Entries whose cpos or dst lie outside
// the buffers, and neighbours outside [0, R), are skipped.
//
// The non-finite rule, with no marks pass.  The plain version multiplies
// every padding slot (zero weight) by its 0 weight, reading src as it stood
// before the round, so a non-finite value in a padding-named block that was
// known before the round makes the entry's element NaN (0 * inf); a block
// recovered in the same round still reads as zeros there.  A round record
// lists the distinct padding-named blocks known before that round (at most
// 32; in the LT codes here block 0 alone, once recovered).  At the round
// record each thread reads its element of each and keeps one bit per block;
// an entry whose padmask meets a set bit stores NaN at that element.  The
// same records give fountain.decode's semantics, the reference's sequential
// scan over the plan's steps (fountain.apply_decode_plan), where a padding
// slot reads src as the previous step left it: one round record per step, in
// plan order (schedule.scan_program).
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NB = 8;                  // neighbour loads issued together
constexpr int MAX_CHUNK_WORDS = 4104;  // schedule.CHUNK_WORDS: 2 * MAX_D + 8
constexpr int OP_ENTRY = 1, OP_ROUND = 2;

// 16 bytes of T at p: one vector load when VECTOR, else element by element
// up to `left` (0 from there on).  STREAM: an evict-first load, for data
// read once.
template <typename T, bool VECTOR, bool STREAM>
__device__ __forceinline__ uint4 load_piece(const T* p, int left) {
    constexpr int VEC = 16 / sizeof(T);
    if (VECTOR) {
        const uint4* q = reinterpret_cast<const uint4*>(p);
        return STREAM ? __ldcs(q) : *q;
    }
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
        if (i < left) e[i] = p[i];
    return raw;
}

template <typename T>
__device__ __forceinline__ void unpack(float (&v)[16 / sizeof(T)], const uint4& raw) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = tiles::to_f32(e[i]);
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 4)
lt_decode_plan_kernel(const T* __restrict__ coded, T* src, const int32_t* __restrict__ prog,
                      int n_words, int R, int n_rx, long long L) {
    constexpr int VEC = 16 / sizeof(T);
    __shared__ __align__(16) int32_t s_prog[MAX_CHUNK_WORDS];

    const long long x = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
    const int left = x < L ? (int)min((long long)VEC, L - x) : 0;
    uint32_t bad[VEC];  // bit q: this element of the round's padding block q is non-finite
#pragma unroll
    for (int i = 0; i < VEC; ++i) bad[i] = 0u;

    for (int base = 0; base < n_words; base += MAX_CHUNK_WORDS) {
        const int n = min(MAX_CHUNK_WORDS, n_words - base);
        __syncthreads();  // every thread is done with the previous chunk
        for (int i = threadIdx.x * 4; i < n; i += THREADS * 4)
            *reinterpret_cast<int4*>(s_prog + i) =
                __ldg(reinterpret_cast<const int4*>(prog + base + i));
        __syncthreads();
        if (left == 0) continue;  // past the block's end: stage the chunks, no work

        for (int p = 0; p < n;) {
            const int head = s_prog[p];
            const int count = head >> 2;
            if (head == 0) break;  // the rest of the chunk is padding
            if ((head & 3) == OP_ROUND) {
                if (p + 2 + count > n) break;  // a malformed program: stop reading it
#pragma unroll
                for (int i = 0; i < VEC; ++i) bad[i] = 0u;
                for (int q = 0; q < count && q < 32; ++q) {
                    const int b = s_prog[p + 2 + q];
                    if ((unsigned)b >= (unsigned)R) continue;
                    float v[VEC];
                    unpack<T>(v, load_piece<T, VECTOR, false>(src + (size_t)b * L + x, left));
#pragma unroll
                    for (int i = 0; i < VEC; ++i)
                        if (!isfinite(v[i])) bad[i] |= 1u << q;
                }
                p += 2 + count;
                continue;
            }
            if ((head & 3) != OP_ENTRY || p + 5 + 2 * count > n) break;
            const int cpos = s_prog[p + 1], dst = s_prog[p + 2];
            const uint32_t padmask = static_cast<uint32_t>(s_prog[p + 3]);
            const float inv_pivot = __int_as_float(s_prog[p + 4]);
            const int* nbr = s_prog + p + 5;
            p += 5 + 2 * count;
            if ((unsigned)cpos >= (unsigned)n_rx || (unsigned)dst >= (unsigned)R) continue;

            float acc[VEC];
            unpack<T>(acc, load_piece<T, VECTOR, true>(coded + (size_t)cpos * L + x, left));
            for (int j0 = 0; j0 < count; j0 += NB) {
                uint4 raw[NB];  // all of a batch's loads before its first subtraction
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const int b = j0 + j < count ? nbr[2 * (j0 + j)] : -1;
                    raw[j] = (unsigned)b < (unsigned)R
                                 ? load_piece<T, VECTOR, false>(src + (size_t)b * L + x, left)
                                 : make_uint4(0u, 0u, 0u, 0u);
                }
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    // A skipped slot loaded zeros: w * 0 adds nothing.
                    const float w = j0 + j < count ? __int_as_float(nbr[2 * (j0 + j) + 1]) : 0.f;
                    float v[VEC];
                    unpack<T>(v, raw[j]);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(-w, v[i], acc[i]);
                }
            }
            if (padmask) {
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    if (bad[i] & padmask) acc[i] = __int_as_float(0x7fc00000);  // 0 * inf
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] *= inv_pivot;
            tiles::store_row_piece<T, VEC>(src + (size_t)dst * L + x, acc, VECTOR, left);
        }
    }
}

template <typename T>
int launch(const void* coded, void* src, const void* prog, int n_words, int R, int n_rx,
           long long L, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(T);
    const long long pieces = (L + VEC - 1) / VEC;
    const dim3 grid((unsigned)((pieces + THREADS - 1) / THREADS));
    const bool vector = L % VEC == 0 && reinterpret_cast<uintptr_t>(coded) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const T* c = static_cast<const T*>(coded);
    T* d = static_cast<T*>(src);
    const int32_t* pg = static_cast<const int32_t*>(prog);
    if (vector)
        lt_decode_plan_kernel<T, true><<<grid, THREADS, 0, s>>>(c, d, pg, n_words, R, n_rx, L);
    else
        lt_decode_plan_kernel<T, false><<<grid, THREADS, 0, s>>>(c, d, pg, n_words, R, n_rx, L);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One peeling plan over blocks of L = bm * cols contiguous elements: src
// (R blocks) is updated in place from coded (n_rx blocks), both of one type
// (dtype 0: float32, 1: bfloat16), by the int32 program `prog` of n_words
// words (a multiple of 4, 16-byte aligned, in chunks of MAX_CHUNK_WORDS).
// Launches on `stream` and returns the first CUDA error.
int lt_decode_plan_launch(const void* coded, void* src, const void* prog, int n_words, int R,
                          int n_rx, int L, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_words % 4) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1) return launch<__nv_bfloat16>(coded, src, prog, n_words, R, n_rx, L, s);
    return launch<float>(coded, src, prog, n_words, R, n_rx, L, s);
}

const char* lt_decode_plan_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
