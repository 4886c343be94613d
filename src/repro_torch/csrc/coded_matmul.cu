// Fused LT-encode + block matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `coded_matmul_pallas`
// (src/repro/kernels/coded_matmul/kernel.py:71, body `_kernel`).  A is R
// row-blocks of bm rows; for every coded block b of C it computes
//
//     V[b] = (sum_j w[b, j] * A[idx[b, j]]) @ X        fp32 accumulation
//
// and writes V in the type of X.
//
// What bounds it on this card.  At the main-path shape (C = 40, bm = 256,
// k = n = 4096) the product is 2*C*bm*k*n = 3.44e11 operations against
// about 0.37 GB that must move, so it is bound by operations.  In fp32 on
// the CUDA cores (67 TFLOP/s on an H100 SXM) that is 5.13 ms.  The tensor
// cores are the only way below it, and they take TF32 (10 mantissa bits).
// One TF32 product misses the reference's fp32 tolerance, 1e-5 x (1 +
// max|ref|), by more than 10x at that shape (an output's rounding error is
// about 4e-4 x sqrt(k); chip_smoke.py's [k1-precision] measures both
// against an fp64 product).  So the float32 instance runs 3xTF32:
// each operand v splits into big = tf32(v) and small = tf32(v - big), both
// truncated, and the product is small.big + big.small + big.big; the
// dropped small.small term is below 2^-20 of a term.  Three TF32 products at the dense TF32 peak
// (495 TFLOP/s) bound it at 2.08 ms; the bytes, 0.11 ms.
//
// The tensor cores' accumulator keeps fewer bits than fp32 as it adds:
// 3xTF32 summed over all of k in one accumulator still missed the
// tolerance on the card, because the small terms, 2^-11 of the running sum,
// lose their low bits.  So each 32-deep k tile's products go into a fresh
// accumulator, which the CUDA cores add to the fp32 sum after the tile;
// its error is then below that of cuBLAS's fp32 product ([k1-precision]).
//
// Design, float32 (the main path): four launches on one stream per call.
//  1. The non-finite row marks (nonfinite_rows.cuh, below).
//  2. The prologue encodes once.  A block with one nonzero-weight
//     neighbour of weight exactly 1 (systematic) is read straight from A;
//     every other block (parities, a weight -1 block, a block with no
//     neighbour in [0, R)) is encoded once, in fp32, into its slot of a
//     scratch buffer the wrapper allocates.  It also writes the per-block
//     row table the product reads: the source block of a direct block, -1
//     for a scratch slot.  Its grid runs the coded blocks fastest, so the
//     parities that name one source row tile read it while it is in L2.
//  3. The prologue splits X^T: wgmma takes a TF32 B operand only K-major
//     from shared memory, and X is (k, n), so a transpose writes X^T's big
//     and small planes, (n, kp) each, kp = k rounded up to 4 (TMA rows are
//     multiples of 16 bytes; where k is not, A's blocks are all copied into
//     the scratch at that stride too).  64 MB each at the main shape.
//  4. The product: one CTA per (128 columns, 128 rows of a block, block):
//     a producer warp keeps a 4-stage ring of (A tile, X^T big tile, X^T
//     small tile), 32 deep, in flight by TMA (128-byte swizzle, mbarriers);
//     two consumer warpgroups of 64 rows read their A fragments from the
//     swizzled tile, split them in registers, and issue small.big,
//     big.small and big.big as wgmma.m64n128k8 with A from registers and
//     B from shared memory.  Ragged rows, k and n are masked (TMA fills
//     zeros past the edges, the epilogue stores only inside), so the
//     caller pads nothing; neighbour indices outside [0, R) are never
//     read.
//
// Non-finite input.  An inf splits into big = inf and small = NaN, so a
// tensor-core output that meets an inf or a NaN comes out non-finite
// wherever the plain fp32 product does (and only there, short of an fp32
// overflow).  The epilogue recomputes each non-finite output as a plain
// fp32 dot product of its encoded row and X column, which gives the plain
// version's inf or NaN.  The plain version also multiplies padding slots
// (weight 0), so a non-finite value in a source row that a block reaches
// only through a padding slot makes that block's row NaN: the marks
// pre-pass flags the source rows that padding slots reach and that hold a
// non-finite value, and the epilogue writes NaN to the output rows whose
// padding slots reach a marked row.  With finite input the marks cost one
// read of the blocks padding slots name (block 0 for the LT codes).
//
// bfloat16 keeps the CUDA-core design (no shape of the main path uses it):
// one CTA per (128 columns, 128 rows, block) re-encodes its A tile at every
// k step, with the next tile's X and first neighbour prefetched into
// registers; fp32 FMA, 8x8 outputs a thread.
//
// Bound with ctypes: a plain C interface, pointers and the stream passed as
// void*, the launch error returned from cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_io.cuh"
#include "nonfinite_rows.cuh"
#include "tma.cuh"

namespace {

using namespace hopper;
using tiles::from_f32;
using tiles::to_f32;

constexpr int THREADS = 256;  // the prologue's and the bfloat16 kernel's CTAs

// s_bad[r] for the CTA's ROWS rows: a padding slot of block b reaches a
// marked (non-finite) source row.  Read only after a later __syncthreads.
template <int ROWS>
__device__ __forceinline__ void mark_bad_rows(uint8_t* s_bad, const int32_t* __restrict__ idx,
                                              const float* __restrict__ w,
                                              const uint8_t* __restrict__ row_bad, int b,
                                              int d_max, int R, int bm, int row0) {
    const int row = row0 + threadIdx.x;
    if (threadIdx.x < ROWS)
        s_bad[threadIdx.x] = row < bm && nonfinite::padding_reaches_nonfinite(
                                             idx + (size_t)b * d_max, w + (size_t)b * d_max,
                                             d_max, R, bm, row, row_bad);
}

// ---- float32: prologue (encode once, split X^T) and the 3xTF32 product ----

constexpr int ENC_ROWS = 4;             // prologue: rows of a coded block per CTA,
constexpr int ENC_COLS = THREADS * 4;   // and columns (4 a thread)

// One CTA per (coded block, ENC_ROWS rows, ENC_COLS columns), blocks
// fastest.  A direct block (one nonzero-weight neighbour, weight exactly 1;
// never when `force`) records its source in the row table and writes
// nothing; every other block writes its encoded rows, sum_j w_j A[src_j] in
// fp32, to its slot of `enc` (row stride kp, zero in the columns k..kp-1).
// Padding terms are not summed: the product's epilogue applies the
// non-finite rule.  Dynamic shared memory: d_max ids, then d_max weights.
template <bool VECTOR>
__global__ void __launch_bounds__(THREADS)
coded_matmul_encode_kernel(const float* __restrict__ a, const int32_t* __restrict__ idx,
                           const float* __restrict__ w, float* __restrict__ enc,
                           int32_t* __restrict__ table, int R, int bm, int k, int kp,
                           int d_max, int force) {
    extern __shared__ int dyn_enc[];
    int* s_src = dyn_enc;
    float* s_w = reinterpret_cast<float*>(dyn_enc + d_max);
    __shared__ int s_nnz;

    const int b = blockIdx.x, row0 = blockIdx.y * ENC_ROWS;
    const int c0 = blockIdx.z * ENC_COLS + threadIdx.x * 4;
    const int nnz = tiles::compact_neighbours(idx + (size_t)b * d_max, w + (size_t)b * d_max,
                                              d_max, R, s_src, s_w, &s_nnz);
    const bool direct = !force && nnz == 1 && s_w[0] == 1.f;
    if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) table[b] = direct ? s_src[0] : -1;
    if (direct || c0 >= kp) return;
    float acc[ENC_ROWS][4] = {};
    for (int j = 0; j < nnz; ++j) {
        const float wj = s_w[j];
        const float* base = a + ((size_t)s_src[j] * bm + row0) * k + c0;
#pragma unroll
        for (int r = 0; r < ENC_ROWS; ++r) {  // ENC_ROWS independent loads a neighbour
            if (row0 + r >= bm) break;
            float v[4];
            if (VECTOR) tiles::load_vec<float, 4, true>(v, base + (size_t)r * k);
            else tiles::load_edge<float, 4>(v, base + (size_t)r * k, k - c0);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(wj, v[i], acc[r][i]);
        }
    }
#pragma unroll
    for (int r = 0; r < ENC_ROWS; ++r) {
        if (row0 + r >= bm) break;
        *reinterpret_cast<float4*>(enc + ((size_t)b * bm + row0 + r) * kp + c0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
}

// The plain fp32 dot product of one encoded row and one X column: the
// plain version's value where the tensor-core sum is not finite.
__device__ __noinline__ float plain_dot(const float* __restrict__ a_row,
                                        const float* __restrict__ x, int k, int n, int col) {
    float s = 0.f;
    for (int i = 0; i < k; ++i) s = fmaf(a_row[i], x[(size_t)i * n + col], s);
    return s;
}

// ---- float32 product on wgmma, fed by TMA ------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 32, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                          // warpgroups, 64 rows each
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;      // + one producer warp
constexpr int WG_TILE_BYTES = WG_BM * WG_BK * 4;         // 16 KB: 128 rows of 128 B
constexpr int WG_STAGE_BYTES = 3 * WG_TILE_BYTES;        // A, X^T big, X^T small
constexpr size_t WG_SMEM = (size_t)WG_STAGES * WG_STAGE_BYTES + 1024;  // + alignment

// The prologue's X step: xt_big / xt_small (n, kp) = the TF32 split of X^T,
// zero in the columns k..kp-1.  32 x 32 tiles through shared memory.
__global__ void __launch_bounds__(256)
coded_matmul_split_xt_kernel(const float* __restrict__ x, float* __restrict__ xt_big,
                             float* __restrict__ xt_small, int k, int n, int kp) {
    __shared__ float tile[32][33];
    const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
        const int kr = k0 + r, c = n0 + tx;
        tile[r][tx] = kr < k && c < n ? x[(size_t)kr * n + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
        const int c = n0 + r, kc = k0 + tx;
        if (c >= n || kc >= kp) continue;
        uint32_t big, small;
        split_tf32(tile[tx][r], big, small);
        xt_big[(size_t)c * kp + kc] = __uint_as_float(big);
        xt_small[(size_t)c * kp + kc] = __uint_as_float(small);
    }
}

struct WgMaps {
    CUtensorMap a, enc, xt_big, xt_small;
};

// One CTA per (128 columns, 128 rows of a block, block): warps 0-7 are two
// consumer warpgroups (64 rows each), warp 8 the producer.  The producer's
// lane 0 keeps WG_STAGES stages of (A tile, X^T big tile, X^T small tile)
// in flight by TMA; a consumer reads its A fragments from the swizzled A
// tile, splits them in registers, and issues small.big, big.small and
// big.big as three wgmma with A from registers and B from shared memory
// into a per-stage accumulator, which it adds to its fp32 sum.
__global__ void __launch_bounds__(WG_THREADS, 1)
coded_matmul_wgmma_kernel(const __grid_constant__ WgMaps maps, const float* __restrict__ a,
                          const float* __restrict__ x, const float* __restrict__ enc,
                          const int32_t* __restrict__ table, const int32_t* __restrict__ idx,
                          const float* __restrict__ w, const uint8_t* __restrict__ row_bad,
                          float* __restrict__ out, int R, int bm, int k, int n, int kp,
                          int d_max) {
    extern __shared__ uint8_t wg_smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
    __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
    __shared__ uint8_t s_bad[WG_BM];

    const int b = blockIdx.z, row0 = blockIdx.y * WG_BM, col0 = blockIdx.x * WG_BN;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int src = table[b];
    mark_bad_rows<WG_BM>(s_bad, idx, w, row_bad, b, d_max, R, bm, row0);
    if (tid == 0) {
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], WG_CONSUMERS);
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int n_kt = (kp + WG_BK - 1) / WG_BK;

    if (warp == 4 * WG_CONSUMERS) {  // the producer warp
        if (lane == 0) {
            const CUtensorMap* amap = src >= 0 ? &maps.a : &maps.enc;
            const int arow = (src >= 0 ? src : b) * bm + row0;
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % WG_STAGES;
                if (kt >= WG_STAGES) mbar_wait(&empty[s], ((kt / WG_STAGES) + 1) & 1);
                uint8_t* st = smem + (size_t)s * WG_STAGE_BYTES;
                mbar_expect_tx(&full[s], WG_STAGE_BYTES);
                tma_load_2d(st, amap, kt * WG_BK, arow, &full[s]);
                tma_load_2d(st + WG_TILE_BYTES, &maps.xt_big, kt * WG_BK, col0, &full[s]);
                tma_load_2d(st + 2 * WG_TILE_BYTES, &maps.xt_small, kt * WG_BK, col0, &full[s]);
            }
        }
        return;
    }

    // Consumer: warpgroup cw owns rows cw*64 .. +63; warp wq of it rows
    // wq*16 .. +15; lane (g, t).
    const int cw = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const int r_lo = cw * 64 + wq * 16 + g;  // and r_lo + 8
    float acc[64], tile[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tile[i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(&full[s], (kt / WG_STAGES) & 1);
        const uint8_t* st = smem + (size_t)s * WG_STAGE_BYTES;
        const float* tA = reinterpret_cast<const float*>(st);
        // The stage's A fragments (rows r_lo, r_lo + 8; columns kk + t and
        // kk + t + 4 of each k8 step) from the 128-byte swizzle: 16-byte
        // chunk c of row r sits at chunk c ^ (r % 8), and r % 8 == g.  All
        // are split before the first wgmma: the registers must stay as they
        // are until the wgmma that read them complete.
        uint32_t big[WG_BK / 8][4], small[WG_BK / 8][4];
#pragma unroll
        for (int q = 0; q < WG_BK / 8; ++q) {
            const int c_lo = ((2 * q) ^ g) * 4 + t, c_hi = ((2 * q + 1) ^ g) * 4 + t;
            split_tf32(tA[r_lo * 32 + c_lo], big[q][0], small[q][0]);
            split_tf32(tA[(r_lo + 8) * 32 + c_lo], big[q][1], small[q][1]);
            split_tf32(tA[r_lo * 32 + c_hi], big[q][2], small[q][2]);
            split_tf32(tA[(r_lo + 8) * 32 + c_hi], big[q][3], small[q][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < WG_BK / 8; ++q) {  // the small terms first
            const uint64_t xb = wgmma_desc(st + WG_TILE_BYTES, q * 32);
            const uint64_t xs = wgmma_desc(st + 2 * WG_TILE_BYTES, q * 32);
            wgmma_tf32_m64n128k8(tile, small[q], xb, q > 0);
            wgmma_tf32_m64n128k8(tile, big[q], xs, 1);
            wgmma_tf32_m64n128k8(tile, big[q], xb, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < WG_BK / 8; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) keep_live(big[q][i], small[q][i]);
        if (lane == 0 && wq == 0) mbar_arrive(&empty[s]);  // the warpgroup is done with it
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += tile[i];
    }

    // acc[4j + e]: row r_lo + 8 (e / 2), column 8j + 2t + e % 2.
    const float qnan = __int_as_float(0x7fc00000);
    const bool pairs = n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
    const float* abase = src >= 0 ? a + (size_t)src * bm * k : enc + (size_t)b * bm * kp;
    const int astride = src >= 0 ? k : kp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h, row = row0 + r;
        if (row >= bm) continue;
        const bool bad = s_bad[r];
        const float* a_row = abase + (size_t)row * astride;
        float* out_row = out + ((size_t)b * bm + row) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int col = col0 + 8 * j + 2 * t;
            float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                if (bad) v[e] = qnan;
                else if (!isfinite(v[e]) && col + e < n)
                    v[e] = plain_dot(a_row, x, k, n, col + e);
            }
            if (pairs && col < n) {
                *reinterpret_cast<float2*>(out_row + col) = make_float2(v[0], v[1]);
            } else {
                if (col < n) out_row[col] = v[0];
                if (col + 1 < n) out_row[col + 1] = v[1];
            }
        }
    }
}

// ---- bfloat16: the CUDA-core kernel ------------------------------------------

constexpr int BM = 128;       // rows of a coded block per CTA
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 8;         // reduction depth per tile
constexpr int A_LD = BM + 4;  // padded row of the k-major encoded tile: conflict-free stores

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
    mark_bad_rows<BM>(s_bad, idx, w, row_bad, b, d_max, R, bm, row0);
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

// A TMA map of a row-major float32 matrix (rows, cols; row stride
// row_floats, a multiple of 4), read in 128-row x 32-column boxes in the
// 128-byte swizzle; reads past the edges give zeros.
bool tile_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
              uint64_t row_floats) {
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {row_floats * sizeof(float)};
    const cuuint32_t box[2] = {WG_BK, WG_BM};
    return float_map(map, base, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

// out (C*bm, n) = coded products of a (R*bm, k) and x (k, n), both of one
// type (dtype 0: float32, 1: bfloat16); idx (C, d_max) int32, w (C, d_max)
// float32; scratch R + R*bm bytes for the non-finite row marks.  float32
// also takes enc, C*bm*kp floats for the encoded blocks (kp = k rounded up
// to a multiple of 4, at least 4), table, C int32, and xt, 2*n*kp floats
// for the split X^T (all written here; unused for bfloat16).  Launches the
// marks, the prologue and the product on `stream` and returns the first
// CUDA error.
int coded_matmul_launch(const void* a, const void* x, const void* idx, const void* w,
                        void* out, void* scratch, void* enc, void* table, void* xt, int R,
                        int bm, int k, int n, int C, int d_max, int dtype, void* stream) {
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
        const dim3 grid((n + BN - 1) / BN, (bm + BM - 1) / BM, C);
        coded_matmul_regs_kernel<__nv_bfloat16><<<grid, THREADS, nbr_bytes, s>>>(
            static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(x), idx32,
            wf, row_bad, static_cast<__nv_bfloat16*>(out), R, bm, k, n, d_max);
        return static_cast<int>(cudaGetLastError());
    }
    const float* af = static_cast<const float*>(a);
    const float* xf = static_cast<const float*>(x);
    float* encf = static_cast<float*>(enc);
    float* xt_big = static_cast<float*>(xt);
    const int kp = k < 4 ? 4 : (k + 3) / 4 * 4;
    float* xt_small = xt_big + (size_t)n * kp;
    int32_t* tab = static_cast<int32_t*>(table);
    // Blocks are read straight from A only where TMA can read A's rows.
    const bool a_rows = k % 4 == 0 && k > 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;

    cudaError_t err = nonfinite::launch_marks(af, R, bm, k, idx32, wf, C * d_max, marks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 enc_grid(C, (bm + ENC_ROWS - 1) / ENC_ROWS, (kp + ENC_COLS - 1) / ENC_COLS);
    if (a_rows)
        coded_matmul_encode_kernel<true><<<enc_grid, THREADS, nbr_bytes, s>>>(
            af, idx32, wf, encf, tab, R, bm, k, kp, d_max, 0);
    else
        coded_matmul_encode_kernel<false><<<enc_grid, THREADS, nbr_bytes, s>>>(
            af, idx32, wf, encf, tab, R, bm, k, kp, d_max, 1);
    coded_matmul_split_xt_kernel<<<dim3((n + 31) / 32, (kp + 31) / 32), 256, 0, s>>>(
        xf, xt_big, xt_small, k, n, kp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    WgMaps maps;
    if (!tile_map(&maps.enc, encf, (uint64_t)C * bm, kp, kp) ||
        !tile_map(&maps.a, a_rows ? static_cast<const void*>(af) : encf,
                  a_rows ? (uint64_t)R * bm : (uint64_t)C * bm, a_rows ? k : kp,
                  a_rows ? k : kp) ||
        !tile_map(&maps.xt_big, xt_big, n, kp, kp) ||
        !tile_map(&maps.xt_small, xt_small, n, kp, kp))
        return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(coded_matmul_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WG_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + WG_BN - 1) / WG_BN, (bm + WG_BM - 1) / WG_BM, C);
    coded_matmul_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(
        maps, af, xf, encf, tab, idx32, wf, row_bad, static_cast<float*>(out), R, bm, k, n, kp,
        d_max);
    return static_cast<int>(cudaGetLastError());
}

const char* coded_matmul_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
